"""Batch-1 admission (``chunked_prefill=False``) of both slot pools against
the JAX package's, on the CPU.

Reduced olmo-1b (2 layers, d_model 64), float32, the same weights in both
packages (the JAX init, converted through numpy), prompts made with
numpy. Held:

* ``Model.prefill(n_valid)`` on a bucket-padded prompt: logits within
  atol 2e-5 of the JAX package's and of the unpadded prompt's prefill
  (float32 on both sides, only the order of float32 sums differs), and
  the valid cache rows within the same tolerance;
* ``_write_slot_tree`` writes the same cache tree as the reference's;
* ``SlotPoolEngine`` and ``SpeculativeSlotPool`` with batch-1 admission,
  prompt buckets on and off, two upgrades a window from stage 1 to 8:
  tokens, per-token stages and admission stages equal to the JAX pools';
* the port's own pools: chunked admission emits the tokens and stages of
  batch-1 admission, per request, at stages 1 and 8 (the reference's
  acceptance case);
* a bucket's padded cache rows are never read: filling them with large
  values changes no token;
* ``run_serving_pool(chunked_prefill=False)``: the event log equals the
  JAX ``Session``'s byte for byte; the CLI runs with ``--no-chunked-prefill``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import wire as jwire
from repro.core.progressive import divide as jax_divide
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import PoolRequest as JPoolRequest
from repro.serving.engine import SlotPoolEngine as JSlotPool
from repro.serving.engine import _write_slot_tree as jax_write_slot_tree
from repro.serving.speculative import SpecConfig as JSpecConfig
from repro.serving.speculative import SpeculativeSlotPool as JSpecPool
from repro.transmission import Session as JSession
from repro.transmission import get_scenario as jget_scenario
from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.progressive import divide
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.serving import PoolRequest, SlotPoolEngine, SpecConfig, SpeculativeSlotPool
from repro_torch.serving.engine import _write_slot_tree
from repro_torch.transmission import Session, flash_crowd_arrivals, get_scenario

REDUCED = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2, n_kv=2)
LOGIT_ATOL = 2e-5
# 5 requests on 3 slots (two queue), prompts 3-11 tokens: buckets 4, 8, 16
LENGTHS, BUDGETS = (5, 11, 3, 8, 6), (6, 9, 4, 7, 6)
MAX_LEN = 32


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("olmo-1b").reduced(**REDUCED)
    cfg = get_config("olmo-1b").reduced(**REDUCED)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, model, jparams, params, jax_divide(jparams), divide(params)


def _prompts(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, REDUCED["vocab"], n).astype(np.int32) for n in LENGTHS]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("L", [3, 5, 8])
def test_prefill_n_valid_matches_reference_and_unpadded(models, L):
    jmodel, model, jparams, params = models[:4]
    bucket = 8
    tokens = _prompts()[1][:L][None, :]
    padded = np.pad(tokens, ((0, 0), (0, bucket - L)))
    want, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(padded)},
                                   n_valid=jnp.asarray([L], jnp.int32))
    got, caches = model.prefill(params, {"tokens": torch.from_numpy(padded)},
                                n_valid=np.asarray([L], np.int32))
    alone, alone_caches = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(_np(got), _np(alone), rtol=0, atol=LOGIT_ATOL)
    for name in ("k", "v"):
        c = caches["cycles"]["0_attn"][name]
        assert tuple(c.shape) == tuple(jcaches["cycles"]["0_attn"][name].shape)
        for other in (jcaches["cycles"]["0_attn"][name][..., :L, :],
                      alone_caches["cycles"]["0_attn"][name]):
            np.testing.assert_allclose(_np(c[..., :L, :]), _np(other), rtol=0,
                                       atol=LOGIT_ATOL)


@pytest.mark.parametrize("n_slots,slot", [(3, 1), (3, 2), (1, 0)])
def test_write_slot_tree_matches_reference(n_slots, slot):
    rng = np.random.default_rng(n_slots + slot)
    shape = (2, n_slots, 2, 10, 4)
    pool = {"cycles": {"0_attn": {k: rng.standard_normal(shape).astype(np.float32)
                                  for k in ("k", "v")}}, "tail": {}}
    one = {"cycles": {"0_attn": {k: rng.standard_normal((2, 1, 2, 10, 4)).astype(np.float32)
                                 for k in ("k", "v")}}, "tail": {}}
    want = jax_write_slot_tree(jax.tree.map(jnp.asarray, pool), jax.tree.map(jnp.asarray, one),
                               slot, n_slots)
    tpool = jax.tree.map(torch.from_numpy, pool)
    got = _write_slot_tree(tpool, jax.tree.map(torch.from_numpy, one), slot, n_slots)
    for k in ("k", "v"):
        assert got["cycles"]["0_attn"][k] is tpool["cycles"]["0_attn"][k]   # in place
        np.testing.assert_array_equal(_np(got["cycles"]["0_attn"][k]),
                                      np.asarray(want["cycles"]["0_attn"][k]))
    with pytest.raises(ValueError, match="batch axis"):
        _write_slot_tree(torch.zeros((2, 3, 4)), torch.zeros((2, 2, 5)), 0, 3)


def _pool_pair(models, speculative, buckets):
    jmodel, model = models[:2]
    jprog, prog = models[4:]
    kw = dict(n_slots=3, max_len=MAX_LEN, dispatch_window=1, chunked_prefill=False,
              prefill_buckets=buckets)
    if speculative:
        return (JSpecPool(jmodel, jprog, spec=JSpecConfig(draft_bits=4, k=2), **kw),
                SpeculativeSlotPool(model, prog, spec=SpecConfig(draft_bits=4, k=2),
                                    device="cpu", **kw))
    return (JSlotPool(jmodel, jprog, resident="quantized", **kw),
            SlotPoolEngine(model, prog, resident="quantized", device="cpu", **kw))


def _drive(pool, request_cls):
    pool.receive_stage()
    for rid, (prompt, budget) in enumerate(zip(_prompts(), BUDGETS)):
        pool.submit(request_cls(rid=rid, prompt=prompt, max_new_tokens=budget))
    # two upgrades a window: stages 1 to 8 within the run
    return pool.run(on_window=lambda _: pool.upgrade_if_available()
                    and pool.upgrade_if_available())


@pytest.mark.parametrize("buckets", [True, False], ids=["buckets", "exact"])
@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "spec"])
def test_batch1_pools_equal_reference(models, speculative, buckets):
    jpool, pool = _pool_pair(models, speculative, buckets)
    jout = _drive(jpool, JPoolRequest)
    out = _drive(pool, PoolRequest)
    assert not pool.chunked_prefill and pool._tick_count == 0
    assert out == jout
    assert pool.stage_log == jpool.stage_log and pool.admit_stage == jpool.admit_stage
    assert pool.upgrades == jpool.upgrades
    stages = {s for log in pool.stage_log.values() for s in log}
    assert {1, 8} <= stages and pool.completed == set(range(len(LENGTHS)))


@pytest.mark.parametrize("stage", [1, 8])
def test_chunked_equals_batch1_per_stage(models, stage):
    """The reference's acceptance case on the port: at a fixed stage,
    chunked admission emits exactly the token stream of batch-1 admission,
    per request, with more requests than slots."""
    model, prog = models[1], models[5]
    outs, logs = [], []
    for chunked in (False, True):
        pool = SlotPoolEngine(model, prog, n_slots=3, max_len=MAX_LEN, dispatch_window=2,
                              resident="quantized", chunked_prefill=chunked, prefill_chunk=4,
                              prefill_buckets=False, device="cpu")
        for _ in range(stage):
            pool.receive_stage()
        for rid, prompt in enumerate(_prompts(seed=2)):
            pool.submit(PoolRequest(rid=rid, prompt=prompt, max_new_tokens=4))
        outs.append(pool.run())
        logs.append(pool.stage_log)
        assert (pool._tick_count > 0) == chunked
    assert outs[0] == outs[1] and logs[0] == logs[1]


def test_bucket_padding_rows_are_never_read(models):
    """The padded rows of a bucket (positions L up to the bucket's end,
    and the grown rows past it) hold values no query reads: filling them
    with large values after admission changes no token."""
    model, prog = models[1], models[5]
    outs = []
    for poison in (False, True):
        pool = SlotPoolEngine(model, prog, n_slots=2, max_len=MAX_LEN, dispatch_window=3,
                              resident="quantized", chunked_prefill=False, device="cpu")
        pool.receive_stage()
        for rid, prompt in enumerate(_prompts(seed=3)[:2]):
            pool.submit(PoolRequest(rid=rid, prompt=prompt, max_new_tokens=6))
            if poison:
                for name in ("k", "v"):
                    c = pool.caches["cycles"]["0_attn"][name]
                    c[:, rid, :, len(prompt):, :] = 1e4
        outs.append(pool.run(on_window=lambda _, p=pool: p.upgrade_if_available()))
    assert outs[0] == outs[1]


def test_session_pool_batch1_log_identical(models):
    jmodel, model, _, _, jprog, prog = models
    blob = wire.encode(prog)
    assert blob == jwire.encode(jprog)
    prompts = _prompts()
    offs = flash_crowd_arrivals(0, len(prompts), span_s=0.5)
    kw = dict(prompts=prompts, arrival_offsets_s=offs, max_new_tokens=4, n_slots=2,
              resident="quantized", chunked_prefill=False)
    jr = JSession.from_scenario(blob, jget_scenario("flash-crowd"), seed=0).run_serving_pool(
        jmodel, jprog, **kw)
    r = Session.from_scenario(blob, get_scenario("flash-crowd"), seed=0,
                              device="cpu").run_serving_pool(model, prog, **kw)
    assert not r.server.chunked_prefill
    assert r.to_jsonl() == jr.to_jsonl()
    assert r.tokens == jr.tokens


def test_cli_without_chunked_prefill(capsys):
    serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--decode-steps", "6",
                "--pool-clients", "4", "--pool-slots", "2", "--no-chunked-prefill"])
    out = capsys.readouterr().out
    assert "served" in out
