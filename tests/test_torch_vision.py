"""llama-3.2-vision-90b's cross path (ROADMAP A8(e)): gated image layers
over ``vision_proj``'s projection of the image embeddings, against the
JAX package on the CPU.

llama-3.2-vision-90b as ``reduced()`` gives it: one cycle of four
``attn`` blocks and a ``cross`` block, d_model 64, 4 heads on 2 KV heads
(hd 16), d_ff 256, vocab 256, 16 image embeddings of width 64, an untied
``lm_head``, float32; the weights as ``tests/test_torch_cross.py`` makes
them, the ``cross`` block's gates drawn away from 0 (the reference
starts them at 0, where the cross path adds nothing), random images
from numpy. Held:

* the division: planes, stage order and wire v3 bytes identical;
  accumulators and ``fingerprint()`` equal at stages 1, 4 and 8, in
  memory and wire-fed;
* ``ProgressiveServer`` in both residencies (logits within
  ``LOGIT_ATOL``, greedy tokens identical at stages 1, 4 and 8) and
  ``SpeculativeEngine`` at stage 8 (tokens identical to the reference's
  and to plain greedy tokens);
* ``SlotPoolEngine`` with ``chunked_prefill=None``: batch-1 admission,
  three requests with images of their own on two slots, upgrades
  mid-stream, a slot reused after an eviction; tokens, stage log and
  admission stages identical to the reference's; the images swapped
  between requests change every request's tokens; images as torch
  tensors give the tokens of numpy ones; ``prefill_buckets`` off gives
  the same tokens; ``SpeculativeSlotPool`` at stage 8 identical
  to the reference's and to the plain pool's;
* refusals: ``chunked_prefill=True``; an unknown ``extras`` key and a
  batched ``(1, T, D)`` image, before anything is admitted or launched;
  a session pool, whose clients send no image (the reference fails
  there too, with a ``KeyError``); the CLI serves ``--arch
  llama-3.2-vision-90b --reduced``, with ``--mesh-shards 2`` token for
  token as without.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.serving import (PoolRequest, SlotPoolEngine, SpecConfig,
                                 SpeculativeSlotPool)
from repro_torch.transmission import Session
from repro_torch.transmission.simulator import BandwidthTrace
from test_torch_cross import (SPEC, check_server, check_speculative, start_cross)
from test_torch_recurrent import MAX_LEN, SIZE, check_config, check_division, cli_tokens

POOL = dict(n_slots=2, max_len=MAX_LEN, dispatch_window=4, resident="quantized")
SPEC_POOL = dict(n_slots=2, max_len=MAX_LEN, dispatch_window=4)


def _requests(seed, lengths):
    """(rid, prompt, budget, image) a request, from numpy."""
    cfg = get_config("llama-3.2-vision-90b").reduced(**SIZE)
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, SIZE["vocab"], L).astype(np.int32), int(rng.integers(10, 16)),
             rng.standard_normal((cfg.vision_tokens, cfg.d_vision)).astype(np.float32))
            for rid, L in enumerate(lengths)]


# three requests on two slots: the third reuses an evicted slot; prompts
# of 12, 20 and 9 tokens (buckets of 16, 32 and 16)
REQUESTS = _requests(6, [12, 20, 9])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vision(tmp_path_factory):
    inputs = {}
    for rid, prompt, _, image in REQUESTS:
        inputs[f"prompt/{rid}"], inputs[f"image/{rid}"] = prompt, image
    a = start_cross(tmp_path_factory.mktemp("vision"), "llama-3.2-vision-90b",
                    ["division", "encode", "receiver", "server/quantized", "server/fp",
                     "spec", "pool", "specpool"],
                    spec={"budgets": [b for _, _, b, _ in REQUESTS], "pool": POOL,
                          "specpool": SPEC_POOL}, **inputs)
    yield a
    a["ref"].close()


def test_config_equals_reference(vision):
    """(Takes the fixture first, which starts the reference's jobs.)"""
    flat = check_config("llama-3.2-vision-90b", {})
    cfg = get_config("llama32-vision-90b")
    assert cfg is get_config("llama-3.2-vision-90b")
    assert (cfg.vision_tokens, cfg.d_vision, cfg.cycle) == (1601, 1280, ("attn",) * 4 + ("cross",))
    assert flat[("vision_proj",)] == (64, 64)
    assert flat[("decoder", "cycles", "4_cross", "gate_attn")] == (1,)
    assert flat[("decoder", "cycles", "4_cross", "attn", "wk")] == (1, 64, 32)


def test_division_equals_reference(vision):
    prog = check_division(vision)
    paths = ["/".join(t.path) for t in prog.tensors]
    assert "vision_proj" in paths and "decoder/cycles/4_cross/gate_mlp" in paths


@pytest.mark.parametrize("resident", ["quantized", "fp"])
def test_server_logits_and_tokens_every_stage(vision, resident):
    check_server(vision, resident)


def test_speculative_equals_reference_and_plain(vision):
    check_speculative(vision)


# ---------------------------------------------------------------------------
# the pool: batch-1 admission with each request's image
# ---------------------------------------------------------------------------

def run_pool(a, requests=REQUESTS, engine=SlotPoolEngine, stage=None, **over):
    """The requests through a pool (from stage 1, an upgrade a window; or
    at ``stage``), each with its image. Returns the pool and its outputs."""
    kw = dict(SPEC_POOL if engine is SpeculativeSlotPool else POOL, **over)
    if engine is SpeculativeSlotPool:
        kw["spec"] = SpecConfig(**SPEC)
    pool = engine(a["model"], a["prog"], device="cpu", **kw)
    for _ in range(stage or 1):
        pool.receive_stage()
    for rid, prompt, budget, image in requests:
        pool.submit(PoolRequest(rid=rid, prompt=prompt, max_new_tokens=budget,
                                extras={"vision_embeds": image}))
    out = pool.run(on_window=None if stage else lambda _: pool.upgrade_if_available())
    return pool, out


def test_pool_tokens_equal_reference(vision):
    """Batch-1 admission (``chunked_prefill`` falls back to False), the
    third request in the slot the first left; tokens, stage log,
    admission stages and upgrades identical to the reference's."""
    import json

    ref = json.loads(str(vision["ref"]["pool"]["run"]))
    pool, out = run_pool(vision)
    assert pool.chunked_prefill is False and ref["chunked"] is False
    assert {str(k): v for k, v in out.items()} == ref["out"]
    assert json.loads(json.dumps({"stage_log": pool.stage_log, "admit_stage": pool.admit_stage,
                                  "upgrades": pool.upgrades})) == \
        {k: ref[k] for k in ("stage_log", "admit_stage", "upgrades")}
    assert pool.stage > 2 and pool.admitted_order == [0, 1, 2]
    assert len({tuple(t) for t in out.values()}) == 3


def test_pool_reads_each_requests_image(vision):
    """The images of requests 0 and 1 swapped: both requests' tokens
    change, so each slot's cross cache holds its own request's memory."""
    _, out = run_pool(vision)
    (r0, p0, b0, i0), (r1, p1, b1, i1), third = REQUESTS
    _, swapped = run_pool(vision, [(r0, p0, b0, i1), (r1, p1, b1, i0), third])
    assert out[0] != swapped[0] and out[1] != swapped[1]


def test_pool_takes_torch_tensor_images(vision):
    """Images submitted as torch tensors give the tokens of the same
    images submitted as numpy arrays, and pass the same shape check."""
    _, out = run_pool(vision)
    as_tensors = [(rid, prompt, budget, torch.from_numpy(image))
                  for rid, prompt, budget, image in REQUESTS]
    _, out_t = run_pool(vision, as_tensors)
    assert out_t == out
    pool = SlotPoolEngine(vision["model"], vision["prog"], device="cpu", **POOL)
    with pytest.raises(ValueError, match="per-request shape"):
        pool.submit(PoolRequest(rid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=4,
                                extras={"vision_embeds": torch.zeros((1, 16, 64))}))


def test_pool_buckets_off_equal_on(vision):
    """Bucket-padded prefills (masked self-attention, the whole image)
    give the tokens of exact-length prefills."""
    pool, out = run_pool(vision)
    exact, out_exact = run_pool(vision, prefill_buckets=False)
    assert pool.prefill_buckets and not exact.prefill_buckets
    assert out == out_exact


def test_spec_pool_equals_reference_and_plain(vision):
    """``SpeculativeSlotPool`` at stage 8, admitting at batch 1: tokens
    identical to the reference's and to a plain pool's at stage 8."""
    import json

    ref = json.loads(str(vision["ref"]["specpool"]["run"]))
    pool, out = run_pool(vision, engine=SpeculativeSlotPool, stage=8)
    _, plain = run_pool(vision, stage=8)
    assert pool.chunked_prefill is False and ref["chunked"] is False
    assert {str(k): v for k, v in out.items()} == ref["out"]
    assert out == plain
    assert sum(sum(r["accepted"]) for r in pool.accept_log) > 0


def test_chunked_prefill_true_raises(vision):
    for engine, kw in ((SlotPoolEngine, POOL), (SpeculativeSlotPool, SPEC_POOL)):
        with pytest.raises(NotImplementedError, match="chunked prefill is not supported for "
                                                      "cross-attention"):
            engine(vision["model"], vision["prog"], chunked_prefill=True, device="cpu", **kw)


@pytest.mark.parametrize("extras,match", [
    ({"audio": np.zeros((16, 64), np.float32)}, r"unknown extras key 'audio'; this arch "
                                                r"accepts \['vision_embeds'\]"),
    ({"vision_embeds": np.zeros((1, 16, 64), np.float32)},
     r"extras\['vision_embeds'\] must have per-request shape \(16, 64\) \(no batch dim\), "
     r"got \(1, 16, 64\)")], ids=["unknown_key", "batched_shape"])
def test_extras_validated_before_admission(vision, extras, match):
    """A bad request raises at submit: nothing queued, admitted or
    launched."""
    pool = SlotPoolEngine(vision["model"], vision["prog"], device="cpu", **POOL)
    pool.receive_stage()
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        pool.submit(PoolRequest(rid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=4,
                                extras=extras))
    assert not pool.queue and not pool.admitted_order and not ops.LAUNCH_COUNTS


def test_session_pool_without_images_raises(vision):
    """The session's pool submits prompts only; the vision arch's prefill
    then has no image and raises, naming it."""
    session = Session(wire.encode(vision["prog"]), BandwidthTrace.constant(1e6), device="cpu")
    with pytest.raises(ValueError, match="vision_embeds"):
        session.run_serving_pool(vision["model"], vision["prog"],
                                 prompts=[np.arange(8, dtype=np.int32)] * 2,
                                 arrival_offsets_s=[0.0, 0.1], max_new_tokens=4, n_slots=2)


@pytest.mark.parametrize("mode", ["default", "quantized", "speculative"])
def test_cli_vision_reduced(mode, capsys):
    """``--arch llama-3.2-vision-90b --reduced`` serves (zeros as the
    image, as the reference launcher makes it)."""
    argv = ["--arch", "llama-3.2-vision-90b", "--reduced", "--device", "cpu",
            "--decode-steps", "8"]
    serve.main(argv + {"default": [], "quantized": ["--resident", "quantized"],
                       "speculative": ["--speculative", "--draft-k", "2"]}[mode])
    assert "served 8 steps across" in capsys.readouterr().out


@pytest.mark.parametrize("flags,exc,match", [
    (["--pool-clients", "2"], ValueError, "vision_embeds"),
    (["--pool-clients", "2", "--chunked-prefill"], NotImplementedError, "cross-attention"),
    (["--mesh-shards", "2"], None, None)],
    ids=["pool", "chunked_pool", "mesh_shards"])
def test_cli_refusals(flags, exc, match, capsys):
    """The session pool and chunked admission raise; ``--mesh-shards 2``
    serves, token for token the run without it."""
    argv = ["--arch", "llama-3.2-vision-90b", "--reduced", "--device", "cpu"]
    if exc is None:
        cli_tokens(argv + ["--decode-steps", "6", "--resident", "quantized"], flags, capsys)
        return
    with pytest.raises(exc, match=match):
        serve.main(argv + flags)
