"""zamba2-7b (ROADMAP A8(d)): Mamba-2 blocks and one shared attention
block, against the JAX package on the CPU.

zamba2-7b as ``reduced(n_layers=13)`` gives it: two cycles of five
``mamba2`` blocks and the ``shared_attn`` block (one set of weights under
``decoder/shared``, a cache for each of its two uses), then a tail of
one ``mamba2`` block; d_model 64, 2 SSM heads of 64, state 16, SSD chunks
of 8 (so prompts of 20 tokens span three), 4 attention heads on 2 KV
heads, d_ff 256, vocab 256, float32. The same numpy-made weights in both
packages; the reference's side runs in processes of its own
(``test_torch_recurrent.Reference``). Held:

* the division: planes, stage order and v3 bytes identical, ``shared``
  where the reference's tree flattening puts it; accumulators and
  ``fingerprint()`` equal at stages 1, 4 and 8, in memory and wire-fed;
* ``ProgressiveServer`` in quantized residency (logits within
  ``LOGIT_ATOL``, greedy tokens identical at stages 1, 4 and 8) and in
  float residency (the same); ``SlotPoolEngine`` with chunked admission:
  tokens, stage log and upgrades identical;
* a 2-layer stack (no full cycle: a tail of two ``mamba2`` blocks, where
  the reference keeps zero-size cycle leaves): prefill and decode logits
  and caches against the reference's;
* ``Model.grow_caches``: recurrent states come back as they are, the
  shared block's KV padded to ``max_len``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models.model import build_model
from test_torch_recurrent import (LOGIT_ATOL, MAX_LEN, SIZE, Reference, _close, _numpy_weights,
                                  _prompt, check_config, check_division, check_pool,
                                  check_server, start_arch)

OVER = dict(n_layers=13)
FORCED = _prompt(7, (2, 3)).tolist()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def zamba(tmp_path_factory):
    a = start_arch(tmp_path_factory.mktemp("zamba2"), "zamba2-7b", OVER,
                   ["division", "encode", "receiver", "server/quantized", "server/fp",
                    "pool/chunked"])
    # the 2-layer stack, on weights of its own
    model2 = build_model(get_config("zamba2-7b").reduced(**SIZE, n_layers=2))
    weights2 = _numpy_weights(model2, seed=2)
    a["two"] = dict(model=model2, params=params_from_numpy(weights2, device="cpu"),
                    ref=Reference(tmp_path_factory.mktemp("zamba2_two"), "zamba2-7b",
                                  dict(n_layers=2), weights2, ["run_stack"],
                                  tokens=a["tokens"], spec={"forced": FORCED}))
    yield a
    for r in (a["ref"], a["two"]["ref"]):
        r.close()


def test_config_equals_reference(zamba):
    """(Takes the fixture first, which starts the reference's jobs.)"""
    flat = check_config("zamba2-7b", OVER)
    cfg = get_config("zamba2-7b")
    assert cfg.cycle == ("mamba2",) * 5 + ("shared_attn",)
    assert (cfg.ssm_heads, cfg.ssm_state, cfg.d_model * cfg.ssm_expand) == (112, 64, 7168)
    assert flat[("decoder", "shared", "attn", "wq")] == (64, 64)
    assert flat[("decoder", "tail", "0_mamba2", "mixer", "in_proj")] == (64, 2 * 128 + 32 + 2)
    assert not any(k[:3] == ("decoder", "cycles", "5_shared_attn") for k in flat)


def test_grow_caches_pads_shared_kv_only(zamba):
    """A prefill's caches grown to ``MAX_LEN``: every recurrent leaf the
    same tensor, the shared block's K/V (one a use: stacked over the two
    cycles) padded along the sequence, rows past the prompt zero."""
    model, cfg = zamba["model"], zamba["cfg"]
    params = zamba["params"]
    _, caches = model.prefill(params, {"tokens": torch.from_numpy(zamba["tokens"])})
    grown = model.grow_caches(caches, MAX_LEN)
    T = zamba["tokens"].shape[1]
    for part in ("cycles", "tail"):
        for slot, c in caches[part].items():
            for name, leaf in c.items():
                g = grown[part][slot][name]
                if slot.endswith("shared_attn"):
                    assert leaf.shape == (2, 2, cfg.n_kv, T, cfg.hd)
                    assert g.shape == (2, 2, cfg.n_kv, MAX_LEN, cfg.hd)
                    assert torch.equal(g[..., :T, :], leaf) and not g[..., T:, :].any()
                else:
                    assert g is leaf, (slot, name)
    assert set(grown["cycles"]) == {f"{j}_mamba2" for j in range(5)} | {"5_shared_attn"}
    assert set(grown["tail"]) == {"0_mamba2"}


def test_run_stack_without_a_full_cycle(zamba):
    """Two layers: ``n_cycles`` 0, a tail of two ``mamba2`` blocks. The
    prefill's and 3 forced decode steps' logits within ``LOGIT_ATOL`` of
    the reference's, the final states within ``LOGIT_ATOL`` too, and the
    stack has no cycle entries."""
    two = zamba["two"]
    model, params = two["model"], two["params"]
    assert model.cfg.n_cycles == 0 and model.cfg.tail == ("mamba2", "mamba2")
    assert not params["decoder"].get("cycles")
    ref = two["ref"]["run_stack"]
    tokens = torch.from_numpy(zamba["tokens"])
    logits, caches = model.prefill(params, {"tokens": tokens})
    assert caches["cycles"] == {}
    _close(ref["prefill"], logits, 0, LOGIT_ATOL)
    caches = model.grow_caches(caches, tokens.shape[1] + len(FORCED[0]))
    for t, tok in enumerate(np.asarray(FORCED).T):
        logits, caches = model.decode_step(params, caches, torch.from_numpy(tok)[:, None],
                                           tokens.shape[1] + t)
        _close(ref[f"decode/{t}"], logits, 0, LOGIT_ATOL, f"step {t}")
    for slot, c in caches["tail"].items():
        for name, leaf in c.items():
            _close(ref[f"cache/tail/{slot}/{name}"], leaf, 0, LOGIT_ATOL, f"{slot}/{name}")
    assert not [k for k in ref if k.startswith("cache/cycles")]


def test_division_equals_reference(zamba):
    prog = check_division(zamba)
    paths = ["/".join(t.path) for t in prog.tensors]
    # the reference's tree flattening: cycles, shared, tail
    first = {part: min(i for i, p in enumerate(paths) if p.startswith(f"decoder/{part}/"))
             for part in ("cycles", "shared", "tail")}
    assert first["cycles"] < first["shared"] < first["tail"]
    assert sum(p.startswith("decoder/shared/") for p in paths) == 9
    assert not any("shared_attn" in p for p in paths)


@pytest.mark.parametrize("resident", ["quantized", "fp"])
def test_server_logits_and_tokens_every_stage(zamba, resident):
    check_server(zamba, resident)


def test_pool_tokens_equal_reference(zamba):
    check_pool(zamba, chunked=True)


def test_pool_decode_masks_states(zamba):
    """In a pool decode step beside a slot mid-way through its chunked
    prefill and a free slot, both keep every cache leaf ``torch.equal``:
    the recurrent states and the shared block's K/V (masked writes)."""
    from repro_torch.serving import PoolRequest, SlotPoolEngine

    pool = SlotPoolEngine(zamba["model"], zamba["prog"], n_slots=3, max_len=MAX_LEN,
                          resident="quantized", prefill_chunk=8, device="cpu")
    pool.receive_stage()
    pool.submit(PoolRequest(rid=0, prompt=_prompt(11, (6,)), max_new_tokens=8))
    pool.step()                                    # slot 0's whole prompt: decoding
    pool.submit(PoolRequest(rid=1, prompt=_prompt(12, (20,)), max_new_tokens=8))
    pool.step()                                    # slot 1: a chunk of 8, 12 to go
    before = {(part, slot): {k: v.clone() for k, v in c.items()}
              for part in ("cycles", "tail") for slot, c in pool.caches[part].items()}
    state = dict(pool._prefill_state)
    assert set(state) == {1}
    # the decode step alone: slot 1 mid-prefill (pos -1) and slot 2 free
    nxt = torch.argmax(pool.last_logits, dim=-1).to(torch.int32)[:, None]
    _, caches = pool.model.decode_step(pool.params, pool.caches, nxt, pool.pos)
    for (part, slot), c in before.items():
        for k, v in c.items():
            now = caches[part][slot][k]
            b_axis = 1 if part == "cycles" else 0
            for s in (1, 2):
                assert torch.equal(now.select(b_axis, s), v.select(b_axis, s)), (slot, k, s)
