"""The dense variants (ROADMAP A8(a)) against the JAX package, on the CPU.

minitron-4b (RMSNorm, tanh GELU, ``head_dim`` 128, GQA G = 3, tied
embeddings) and starcoder2-15b (affine LayerNorm, tanh GELU, rope theta
1e5, untied ``lm_head``), reduced: 2 layers, d_model 64, d_ff 128, vocab
256; minitron with 6 heads on 2 KV heads (its published G = 3, head_dim
32), starcoder2 with 4 heads on 1 (hd 16). Float32, the same weights in
both packages: the JAX init, converted through numpy, whose ``norm1``
leaves keep the init's constants (ones and zeros: the quantizer's
widened range of a constant tensor) while ``norm2`` and ``final_norm``
are redrawn from a numpy seed, so that a norm's scale and bias change
the logits. Held:

* the configs equal the reference's, field for field;
* the norms and the activation within 1e-6 of the reference's functions;
* v3 wire bytes exactly, and the client's accumulators and
  ``fingerprint()`` at every stage, fed in seeded ragged chunks, equal
  the JAX client's and an in-memory receiver's;
* prefill and teacher-forced decode logits of both residencies within
  ``LOGIT_ATOL`` at every stage; ``resident_report`` equal, float leaves
  (the norms) counted;
* greedy tokens identical with upgrades landing mid-decode, in both
  residencies and from wire bytes;
* the slot pool's tokens (chunked and batch-1 admission) and
  ``SpeculativeEngine``'s tokens identical to the JAX engines';
* ``launch.serve --arch <arch> --reduced --device cpu`` runs to its end.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import wire as jwire
from repro.core.progressive import divide as jax_divide
from repro.models import common as jcommon
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import PoolRequest as JPoolRequest
from repro.serving.engine import ProgressiveServer as JServer
from repro.serving.engine import SlotPoolEngine as JSlotPool
from repro.serving.speculative import SpecConfig as JSpecConfig
from repro.serving.speculative import SpeculativeEngine as JSpecEngine
from repro.transmission import ProgressiveClient as JClient
from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.progressive import ReceiverState, divide, tree_flatten_with_path
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import common
from repro_torch.models.model import build_model
from repro_torch.serving import (PoolRequest, ProgressiveServer, SlotPoolEngine, SpecConfig,
                                 SpeculativeEngine, WireStoreReceiver)
from repro_torch.transmission import ProgressiveClient

ARCHS = {"minitron-4b": dict(n_heads=6, n_kv=2), "starcoder2-15b": dict(n_heads=4, n_kv=1)}
SIZE = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
LOGIT_ATOL = 2e-5       # as tests/test_torch_serving.py: float32, sums in other orders
NORM_ATOL = 1e-6
PROMPT, STEPS = 8, 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch(request):
    """One arch's JAX model and port model over the same weights, and
    both divided models (uniform 2-bit planes into uint16)."""
    name = request.param
    jcfg = jax_get_config(name).reduced(**SIZE, **ARCHS[name])
    cfg = get_config(name).reduced(**SIZE, **ARCHS[name])
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    weights = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    for tree in (weights["decoder"]["cycles"]["0_attn"]["norm2"], weights["final_norm"]):
        for k, v in tree.items():
            base = 1.0 if k == "scale" else 0.0
            tree[k] = (base + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, weights)
    params = params_from_numpy(weights, device="cpu")
    return dict(name=name, jmodel=jmodel, model=model, jprog=jax_divide(jparams),
                prog=divide(params))


def _prompt(seed, shape):
    return np.random.default_rng(seed).integers(0, SIZE["vocab"], shape).astype(np.int32)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(want, got):
    np.testing.assert_allclose(np.asarray(want), _np(got), rtol=0, atol=LOGIT_ATOL)


# ---------------------------------------------------------------------------
# configs and the model's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_configs_equal_reference(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    fields = [f.name for f in dataclasses.fields(cfg) if f.name != "dtype"]
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    assert cfg.hd == jcfg.hd == 128
    red, jred = cfg.reduced(**ARCHS[name]), jcfg.reduced(**ARCHS[name])
    assert {f: getattr(red, f) for f in fields} == {f: getattr(jred, f) for f in fields}
    assert red.hd == jred.hd and red.n_heads // red.n_kv == jred.n_heads // jred.n_kv
    assert get_config("olmo-1b").norm_type == "nonparam_ln"
    for later in ("seamless-m4t-medium", "llama-3.2-vision-90b", "progressivenet-cnn"):
        with pytest.raises(NotImplementedError, match="A8"):
            get_config(later)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_and_activation_equal_reference(norm_type):
    """Each norm on float32 and bfloat16 rows with seeded scale and bias;
    GELU is the tanh approximation (the erf form differs by ~1e-4)."""
    rng = np.random.default_rng(7)
    cfg = dataclasses.replace(get_config("minitron-4b"), norm_type=norm_type)
    jcfg = dataclasses.replace(jax_get_config("minitron-4b"), norm_type=norm_type)
    d = 96
    p = {k: (rng.standard_normal(d) * 0.3 + (1.0 if k == "scale" else 0.0)).astype(np.float32)
         for k in common.norm_init(cfg, d, device="cpu")}
    x = (rng.standard_normal((5, 3, d)) * 2.0 + 0.5).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = common.apply_norm(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x).to(dt))
        want = jcommon.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x, jdt))
        assert got.dtype == dt
        atol = NORM_ATOL if dt == torch.float32 else 2.0 ** -6 * float(np.abs(want).max())
        np.testing.assert_allclose(np.asarray(want.astype(jnp.float32)), _np(got.float()),
                                   rtol=0, atol=atol)
    assert sorted(p) == sorted(jcommon.norm_init(jcfg, d))
    xt = torch.from_numpy(x)
    act = common.activation(cfg, xt)
    np.testing.assert_allclose(np.asarray(jcommon.activation(jcfg, jnp.asarray(x))), _np(act),
                               rtol=0, atol=NORM_ATOL)
    assert float((torch.nn.functional.gelu(xt) - act).abs().max()) > 10 * NORM_ATOL


def test_param_trees_equal_reference(arch):
    """The same leaves, shapes and dtypes as the JAX init: stacked norms,
    ``lm_head`` exactly when untied."""
    model = arch["model"]
    ours = model.init(torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.eval_shape(arch["jmodel"].init, jax.random.PRNGKey(0))
    flat = {tuple(p.key for p in path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert {p: tuple(t.shape) for p, t in tree_flatten_with_path(ours)} == flat
    assert (("lm_head",) in flat) == (not model.cfg.tie_embeddings)
    assert all(t.dtype == torch.float32 for _, t in tree_flatten_with_path(ours))


# ---------------------------------------------------------------------------
# bytes, accumulators, fingerprints
# ---------------------------------------------------------------------------

def _stage_ends(blob):
    meta, hdr = wire.decode_header(blob)
    return np.cumsum([hdr] + wire.layout_from_header(meta, hdr).stage_bytes).tolist()


def _buffers(store):
    return {k: _np(v).tobytes() for k, v in store.buffers.items()}


def test_wire_accumulators_fingerprints_every_stage(arch):
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
        assert client.stages_complete == jclient.stages_complete == s
        assert client.store.fingerprint() == jclient.store.fingerprint() \
            == st.store.fingerprint(), f"stage {s}"
        assert _buffers(client.store) == _buffers(jclient.store) == _buffers(st.store)
    # the constant norm1 leaves (lo == hi: eq. (2)'s widened range)
    # divide as the reference divides them
    consts = [(t, j) for t, j in zip(prog.tensors, jprog.tensors) if "norm1" in t.path]
    assert consts and all(float(t.lo) == float(j.lo) == float(t.hi) == float(j.hi)
                          for t, j in consts)


# ---------------------------------------------------------------------------
# logits and tokens against the JAX engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resident", ["quantized", "fp"])
def test_logits_every_stage(arch, resident):
    """At every stage: the prefill logits, then teacher-forced decode
    logits (the same tokens fed to both), and the resident audit."""
    jmodel, model = arch["jmodel"], arch["model"]
    tokens = _prompt(1, (2, PROMPT))
    forced = _prompt(2, (2, 3))
    jsrv = JServer(jmodel, arch["jprog"], max_len=PROMPT + 3, resident=resident)
    srv = ProgressiveServer(model, arch["prog"], max_len=PROMPT + 3, resident=resident,
                            device="cpu")
    for s in range(1, arch["prog"].n_stages + 1):
        jsrv.receive_stage()
        srv.receive_stage()
        jsrv.start({"tokens": jnp.asarray(tokens)})
        srv.start({"tokens": tokens})
        _close(jsrv.last_logits, srv.last_logits)
        jcaches, caches = jsrv.caches, srv.caches
        for t in range(forced.shape[1]):
            tok = forced[:, t:t + 1]
            jl, jcaches = jsrv._decode(jsrv.params, jcaches, jnp.asarray(tok),
                                       jnp.int32(jsrv.pos + t))
            lg, caches = model.decode_step(srv.params, caches, torch.from_numpy(tok),
                                           srv.pos + t)
            _close(jl, lg)
        rep = srv.resident_report()
        assert rep == jsrv.resident_report(), f"stage {s}"
    # quantized residency keeps the norms' leaves float: norm1, norm2 and
    # final_norm, each a scale (and a bias for LayerNorm)
    if resident == "quantized":
        assert rep["fp_leaves"] == 3 * len(common.norm_init(model.cfg, 1, device="cpu"))
    assert rep["fp_bytes"] > 0
    assert ("lm_head" in srv.params) == (not model.cfg.tie_embeddings)


def _decode_run(eng, tokens, steps, arrivals):
    eng.receive_stage()
    eng.start({"tokens": tokens})
    return eng.decode(steps, stage_arrival=lambda i: i in arrivals)


@pytest.mark.parametrize("resident", ["quantized", "fp"])
def test_greedy_tokens_with_midstream_upgrades(arch, resident):
    """Stages 2-8 land between decode steps; the tokens equal the JAX
    server's, and a server fed the v3 bytes a stage at each arrival."""
    jmodel, model, prog = arch["jmodel"], arch["model"], arch["prog"]
    steps = 2 * prog.n_stages + 2
    arrivals = set(range(2, 2 * prog.n_stages, 2))
    tokens = _prompt(3, (2, PROMPT))
    jsrv = JServer(jmodel, arch["jprog"], max_len=PROMPT + steps, resident=resident)
    srv = ProgressiveServer(model, prog, max_len=PROMPT + steps, resident=resident,
                            device="cpu")
    jres = _decode_run(jsrv, jnp.asarray(tokens), steps, arrivals)
    res = _decode_run(srv, tokens, steps, arrivals)
    assert res.upgrades == jres.upgrades and res.stage_at_step == jres.stage_at_step
    assert res.stage_at_step[-1] == prog.n_stages
    np.testing.assert_array_equal(_np(res.tokens), np.asarray(jres.tokens))
    _close(jsrv.last_logits, srv.last_logits)
    # the same stream from v3 wire bytes
    blob = wire.encode(prog, integrity=True)
    ends = _stage_ends(blob)
    client = ProgressiveClient(device="cpu")
    wired = ProgressiveServer(model, prog, max_len=PROMPT + steps, resident=resident,
                              device="cpu", receiver=WireStoreReceiver(client, prog))
    client.feed(blob[:ends[1]])

    def arrive(i):
        if i in arrivals:
            client.feed(blob[ends[client.stages_complete]:ends[client.stages_complete + 1]])
            return True
        return False

    wired.receive_stage()
    wired.start({"tokens": tokens})
    wres = wired.decode(steps, stage_arrival=arrive)
    assert torch.equal(wres.tokens, res.tokens) and wres.upgrades == res.upgrades
    assert wired.resident_report() == srv.resident_report()


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "batch1"])
def test_pool_tokens_equal_reference(arch, chunked):
    jmodel, model = arch["jmodel"], arch["model"]
    rng = np.random.default_rng(4)
    reqs = [(rid, rng.integers(0, SIZE["vocab"], int(rng.integers(3, 12))).astype(np.int32),
             int(rng.integers(3, 8))) for rid in range(5)]
    kw = dict(n_slots=3, max_len=24, dispatch_window=2, prefill_chunk=4,
              chunked_prefill=chunked, resident="quantized")
    pools = [JSlotPool(jmodel, arch["jprog"], **kw),
             SlotPoolEngine(model, arch["prog"], device="cpu", **kw)]
    outs = []
    for pool, cls in zip(pools, (JPoolRequest, PoolRequest)):
        pool.receive_stage()
        for rid, prompt, budget in reqs:
            pool.submit(cls(rid=rid, prompt=prompt, max_new_tokens=budget))
        outs.append(pool.run(on_window=lambda _, p=pool: p.upgrade_if_available()))
    jpool, pool = pools
    assert outs[1] == {rid: list(map(int, t)) for rid, t in outs[0].items()}
    assert pool.stage_log == jpool.stage_log and pool.admit_stage == jpool.admit_stage
    assert pool.upgrades == jpool.upgrades and pool.stage > 2
    assert pool.resident_report() == jpool.resident_report()


def test_speculative_tokens_equal_reference_and_plain(arch):
    """k = 4, draft 4 bits, at stages 1, 4 and 8 from a fresh start: the
    tokens and rounds equal the JAX engine's, and the tokens the plain
    server's; the draft shares the target's float leaves."""
    jmodel, model, prog = arch["jmodel"], arch["model"], arch["prog"]
    tokens = _prompt(6, (2, PROMPT))
    max_len = PROMPT + STEPS + 9
    jeng = JSpecEngine(jmodel, arch["jprog"], max_len=max_len,
                       spec=JSpecConfig(draft_bits=4, k=4))
    eng = SpeculativeEngine(model, prog, max_len=max_len, spec=SpecConfig(draft_bits=4, k=4),
                            device="cpu")
    plain = ProgressiveServer(model, prog, max_len=max_len, resident="quantized",
                              device="cpu")
    drafted = 0
    for s in range(1, prog.n_stages + 1):
        for e in (jeng, eng, plain):
            e.receive_stage()
        if s not in (1, 4, 8):
            continue
        for e in (jeng, eng, plain):
            e.start({"tokens": tokens})
        jres, res = jeng.decode(STEPS), eng.decode(STEPS)
        np.testing.assert_array_equal(_np(res.tokens), np.asarray(jres.tokens),
                                      err_msg=f"stage {s}")
        assert [(r["k"], r["accepted"]) for r in res.accept_rounds] == \
            [(r["k"], r["accepted"]) for r in jres.accept_rounds]
        assert torch.equal(res.tokens, plain.decode(STEPS).tokens), f"stage {s}"
        drafted += res.drafted
    assert drafted > 0
    rep = eng.resident_report()
    assert rep["extra_draft_bytes"] == 0 and rep["fp_bytes"] > 0
    norm = "decoder/cycles/0_attn/norm1/scale".split("/")
    t, d = eng.params, eng.draft_params
    for k in norm:
        t, d = t[k], d[k]
    assert t is d


def test_cli_runs_reduced(arch, capsys):
    serve.main(["--arch", arch["name"], "--reduced", "--device", "cpu", "--decode-steps", "6"])
    out = capsys.readouterr().out
    assert "fp-resident" in out and "served 6 steps across 8 precision stages" in out
