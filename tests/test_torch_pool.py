"""The port's continuous-batching slot pool against the JAX package's,
on the CPU.

Reduced olmo-1b (2 layers, d_model 64), float32, the same weights in
both packages (the JAX init, converted through numpy), prompts made with
numpy. Held:

* ``Model.prefill_chunk`` and ``Model.verify_step`` logits within atol
  2e-5 at stages 1 and 8 (float32 on both sides, only the order of
  float32 sums differs), and the cache rows of masked slots and rows
  byte-identical before and after each call;
* ``SlotPoolEngine`` with the same settings emits the same tokens, stage
  log, admission stages, upgrades and window counts as the JAX pool, for
  uint8, uint16 and uint32 containers, with queueing, prompts spanning
  several chunks, an upgrade every window, and eos;
* malformed requests raise the reference's errors before any device
  work; every part left for later raises ``NotImplementedError`` naming
  its ROADMAP item;
* neither ``step()`` nor the prefill tick reads a tensor back to the
  host; ``flush()`` reads the window's tokens once.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.bitplanes import PlaneSchedule as JSchedule
from repro.core.policy import UniformPolicy as JUniformPolicy
from repro.core.progressive import divide as jax_divide
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import PoolRequest as JPoolRequest
from repro.serving.engine import SlotPoolEngine as JSlotPool
from repro_torch.configs import get_config
from repro_torch.core.bitplanes import PlaneSchedule
from repro_torch.core.policy import UniformPolicy
from repro_torch.core.progressive import divide
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.model import build_model
from repro_torch.serving.engine import PoolRequest, SlotPoolEngine

REDUCED = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2, n_kv=2)
LOGIT_ATOL = 2e-5
SCHEDULES = {"uint8": (8, (2, 2, 2, 2)), "uint16": (16, (2,) * 8),
             "uint32": (20, (5, 5, 5, 5))}
POOL = dict(n_slots=3, max_len=24, resident="quantized", dispatch_window=2,
            prefill_chunk=4)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("olmo-1b").reduced(**REDUCED)
    cfg = get_config("olmo-1b").reduced(**REDUCED)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, model, jparams, params


@pytest.fixture(scope="module")
def jitted(models):
    """The JAX model's entry points, each compiled once for the module."""
    return {name: jax.jit(getattr(models[0], name))
            for name in ("prefill_chunk", "decode_step", "verify_step")}


def _progs(models, container):
    _, _, jparams, params = models
    bits, widths = SCHEDULES[container]
    return (jax_divide(jparams, JUniformPolicy(schedule=JSchedule(bits, widths))),
            divide(params, UniformPolicy(schedule=PlaneSchedule(bits, widths))))


def _pools(models, container, **kw):
    jmodel, model = models[:2]
    jprog, prog = _progs(models, container)
    settings = {**POOL, **kw}
    return (JSlotPool(jmodel, jprog, **settings),
            SlotPoolEngine(model, prog, device="cpu", **settings))


def _requests(seed=0, n=5):
    """Prompts of 2-11 tokens (up to three 4-token chunks), budgets 3-8:
    more requests than slots, so admission queues."""
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, REDUCED["vocab"], int(rng.integers(2, 12))
                               ).astype(np.int32), int(rng.integers(3, 9)))
            for rid in range(n)]


def _run(pool, request_cls, requests, *, upgrade_every_window=True):
    for rid, prompt, budget in requests:
        pool.submit(request_cls(rid=rid, prompt=prompt, max_new_tokens=budget))
    on_window = (lambda _: pool.upgrade_if_available()) if upgrade_every_window else None
    return pool.run(on_window=on_window)


def _window_counts(pool):
    return [(w.steps, w.tokens_emitted, w.upgrades, w.prefill_ticks)
            for w in pool.window_stats]


# ---------------------------------------------------------------------------
# the model's multi-row entry points
# ---------------------------------------------------------------------------

def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=0,
                               atol=LOGIT_ATOL)


def _slot_rows(caches, slot):
    """Every layer's K and V rows of one slot, cloned."""
    c = caches["cycles"]["0_attn"]
    return [c[n][:, slot].clone() for n in ("k", "v")]


def _same_rows(caches, slot, before):
    return all(torch.equal(a, b) for a, b in zip(_slot_rows(caches, slot), before))


@pytest.mark.parametrize("stage", [1, 8])
def test_prefill_chunk_and_verify_step_logits(models, jitted, stage):
    """A chunk tick with a slot at its first chunk, a free slot and a short
    final chunk; a second tick; a decode step with a mid-prefill slot
    (pos = -1); then a verify block with a free slot. Logits and the
    written caches against JAX; masked slots' cache rows unchanged."""
    jmodel, model = models[:2]
    jpool, pool = _pools(models, "uint16")
    for _ in range(stage):
        jpool.receive_stage()
        pool.receive_stage()
    B, S = POOL["n_slots"], POOL["max_len"]
    jcaches = jmodel.init_caches(B, S)
    caches = model.init_caches(B, S, device="cpu")
    rng = np.random.default_rng(stage)
    calls = [
        ("prefill_chunk", [[0, 1, 2, 3], [-1] * 4, [0, 1, -1, -1]], (1,)),
        ("prefill_chunk", [[4, 5, 6, -1], [-1] * 4, [-1] * 4], (1, 2)),
        ("decode_step", [7, -1, 2], (1,)),
        ("verify_step", [8, -1, 3], (1,)),
    ]
    for name, pos, masked in calls:
        pos = np.asarray(pos, np.int32)
        width = 3 if name == "verify_step" else (1 if pos.ndim == 1 else pos.shape[1])
        toks = rng.integers(0, REDUCED["vocab"], (B, width)).astype(np.int32)
        before = {s: _slot_rows(caches, s) for s in masked}
        jl, jcaches = jitted[name](jpool.params, jcaches, jnp.asarray(toks),
                                   jnp.asarray(pos))
        lg, caches = getattr(model, name)(pool.params, caches, torch.from_numpy(toks),
                                          torch.from_numpy(pos))
        # masked rows too: both plain versions attend them to nothing alike
        _close(np.asarray(jl).reshape(B, width, -1), lg.reshape(B, width, -1))
        for s in masked:
            assert _same_rows(caches, s, before[s]), f"{name} wrote slot {s}"
        for n in ("k", "v"):
            np.testing.assert_allclose(np.asarray(jcaches["cycles"]["0_attn"][n]),
                                       caches["cycles"]["0_attn"][n].numpy(),
                                       rtol=0, atol=LOGIT_ATOL)


# ---------------------------------------------------------------------------
# the pool against the JAX pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("container", sorted(SCHEDULES))
def test_pool_matches_jax_with_upgrades_every_window(models, container):
    jpool, pool = _pools(models, container)
    jpool.receive_stage()
    pool.receive_stage()
    reqs = _requests()
    jout = _run(jpool, JPoolRequest, reqs)
    out = _run(pool, PoolRequest, reqs)
    assert out == jout
    assert all(len(out[rid]) == budget for rid, _, budget in reqs)
    assert pool.stage_log == jpool.stage_log
    assert pool.admit_stage == jpool.admit_stage
    assert pool.upgrades == jpool.upgrades
    assert pool.stage == len(SCHEDULES[container][1])
    assert pool.admitted_order == jpool.admitted_order
    assert pool.completed == jpool.completed == set(out)
    assert _window_counts(pool) == _window_counts(jpool)
    assert pool._tick_count == jpool._tick_count > 0
    assert [(u["step"], u["stage"], u["double_buffer"]) for u in pool.upgrade_log] == \
        [(u["step"], u["stage"], u["double_buffer"]) for u in jpool.upgrade_log]
    assert set(pool.ttft_s) == set(out)
    assert pool.resident_report() == jpool.resident_report()


def test_fenced_upgrades_emit_the_same_tokens(models):
    """``double_buffer=False`` waits for the device after each upgrade;
    what the pool emits does not change."""
    _, prog = _progs(models, "uint8")
    runs = []
    for double_buffer in (True, False):
        pool = SlotPoolEngine(models[1], prog, device="cpu", double_buffer=double_buffer,
                              **POOL)
        pool.receive_stage()
        runs.append((_run(pool, PoolRequest, _requests()), pool.upgrades,
                     {u["double_buffer"] for u in pool.upgrade_log}))
    assert runs[0][:2] == runs[1][:2]
    assert (runs[0][2], runs[1][2]) == ({True}, {False})


def test_pool_eos_matches_jax(models):
    """The eos id is a token whose first occurrence in one request's free
    run is known and falls before its last token (the latest such first
    occurrence over the requests); both pools stop every request at its
    first eos, and that request ends early."""
    jfree, _ = _pools(models, "uint16")
    for _ in range(8):
        jfree.receive_stage()
    reqs = _requests(seed=1)
    free = _run(jfree, JPoolRequest, reqs, upgrade_every_window=False)
    at, rid = max((i, rid) for rid, toks in free.items()
                  for i in range(1, len(toks) - 1) if toks[i] not in toks[:i])
    jpool, pool = _pools(models, "uint16", eos_id=free[rid][at])
    for _ in range(8):
        jpool.receive_stage()
        pool.receive_stage()
    jout = _run(jpool, JPoolRequest, reqs, upgrade_every_window=False)
    out = _run(pool, PoolRequest, reqs, upgrade_every_window=False)
    assert out == jout
    assert out[rid] == free[rid][:at + 1] and len(out[rid]) < len(free[rid])
    assert pool.completed == jpool.completed == set(out)
    assert _window_counts(pool) == _window_counts(jpool)


def test_malformed_requests_raise_reference_errors_before_device_work(models):
    jpool, pool = _pools(models, "uint16")
    jpool.receive_stage()
    pool.receive_stage()
    ops.reset_launch_counts()
    ok = np.arange(4, dtype=np.int32)
    bad = [dict(prompt=ok, max_new_tokens=0),
           dict(prompt=ok[None], max_new_tokens=2),
           dict(prompt=ok[:0], max_new_tokens=2),
           dict(prompt=np.arange(20, dtype=np.int32), max_new_tokens=5),
           dict(prompt=ok, max_new_tokens=2, extras={"vision_embeds": np.zeros((4, 8))})]
    for i, kw in enumerate(bad):
        with pytest.raises(ValueError) as jerr:
            jpool.submit(JPoolRequest(rid=i, **kw))
        with pytest.raises(ValueError) as err:
            pool.submit(PoolRequest(rid=i, **kw))
        assert str(err.value) == str(jerr.value)
    assert not ops.LAUNCH_COUNTS
    assert not pool.queue and not pool.outputs and pool._tick_count == 0
    assert all(s.free for s in pool.slots)


@pytest.mark.parametrize("kw", [
    # a mesh of model shards alone is ported (tests/test_torch_sharded.py);
    # replica rows are not
    dict(mesh=make_serving_mesh(2, n_data=2, devices=["cpu"] * 4)), dict(window=8),
    dict(telemetry="1")],
    ids=["mesh", "window", "telemetry"])
def test_parts_left_for_later_raise(models, monkeypatch, kw):
    model = models[1]
    _, prog = _progs(models, "uint8")
    if "window" in kw:
        # sliding windows (tests/test_torch_sliding_window.py) and recurrent
        # blocks (tests/test_torch_recurrent.py) are ported: such a pool
        # admits without buckets; a recurrent pool on a mesh is not ported
        swa = build_model(model.cfg.reduced(**REDUCED, cycle=("swa",), window=kw.pop("window")))
        assert not SlotPoolEngine(swa, prog, device="cpu", **POOL).prefill_buckets
        model = build_model(model.cfg.reduced(**REDUCED, cycle=("mamba2",)))
        assert not SlotPoolEngine(model, prog, device="cpu", **POOL).prefill_buckets
        prog = divide(model.init(torch.Generator(), device="cpu"))
        kw["mesh"] = make_serving_mesh(2, devices=["cpu"] * 2)
    if "telemetry" in kw:
        monkeypatch.setenv("REPRO_TELEMETRY", kw.pop("telemetry"))
    settings = {**POOL, **kw}
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        SlotPoolEngine(model, prog, device="cpu", **settings)


# ---------------------------------------------------------------------------
# no host sync inside a dispatch window
# ---------------------------------------------------------------------------

class _HostReads:
    """Counts, by name, the tensor methods that read device values back to
    the host, and ``torch.cuda.synchronize``."""

    NAMES = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__", "__float__",
             "__index__", "__array__")

    def __init__(self, monkeypatch):
        self.counts = collections.Counter()
        self.on = False
        for name in self.NAMES:
            monkeypatch.setattr(torch.Tensor, name, self._wrap(name,
                                                               getattr(torch.Tensor, name)))
        monkeypatch.setattr(torch.cuda, "synchronize",
                            self._wrap("synchronize", torch.cuda.synchronize))

    def _wrap(self, name, fn):
        def counted(*a, **k):
            if self.on:
                self.counts[name] += 1
            return fn(*a, **k)
        return counted

    def during(self, fn):
        self.counts.clear()
        self.on = True
        try:
            fn()
        finally:
            self.on = False
        return dict(self.counts)


def test_window_reads_the_device_once(models, monkeypatch):
    """Steps and prefill ticks read nothing back; ``flush()`` reads the
    window's tokens with one ``.cpu()``; an upgrade after the first
    reads nothing back either."""
    _, pool = _pools(models, "uint16")
    pool.receive_stage()
    for rid, prompt, budget in _requests(seed=2, n=4):
        pool.submit(PoolRequest(rid=rid, prompt=prompt, max_new_tokens=budget))
    reads = _HostReads(monkeypatch)
    windows = 0
    while any(not s.free for s in pool.slots) or pool.queue:
        assert reads.during(lambda: [pool.step() for _ in range(pool.dispatch_window)
                                     if any(not s.free for s in pool.slots)]) == {}
        want = {"cpu": 1, "numpy": 1} if pool._pending else {}
        assert reads.during(pool.flush) == want
        assert reads.during(pool.upgrade_if_available) == {}
        pool._admit_from_queue()
        windows += 1
    assert windows > 2 and pool._tick_count > 2 and pool.stage > 2
    assert set(pool.completed) == {0, 1, 2, 3}
