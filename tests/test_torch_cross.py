"""Cross attention and encoders (ROADMAP A8(e)): the attention functions
and seamless-m4t-medium served whole, against the JAX package on the CPU.

seamless-m4t-medium as ``reduced()`` gives it: 2 ``enc_attn`` encoder
blocks and 2 ``selfcross`` decoder blocks, d_model 64, 4 heads on 2 KV
heads (hd 16), d_ff 256, vocab 256, affine LayerNorm, tanh GELU, tied
embeddings, float32; a prompt of 20 tokens and an ``enc_input`` of
``20 // 4`` frames, both made with numpy. The same numpy-made weights in
both packages (the port's seeded init, the norms' scales and biases
spread so that each changes the outputs). Held:

* ``chunked_attention(causal=False)``, ``cross_attention`` (chunked at
  prefill; through B3 at Tq = 1 and B4 at Tq = 5 over a native cache,
  every row at ``q_pos = Tv``), ``cross_kv`` and an ``enc_attn`` block,
  with and without ``qk_norm``, within ``RTOL``/``ATOL`` of the
  reference's on seeded inputs;
* the division: planes, stage order and wire v3 bytes identical;
  accumulators and ``fingerprint()`` equal at stages 1, 4 and 8, in
  memory and wire-fed (``test_torch_recurrent.check_division``);
* ``ProgressiveServer`` in both residencies: logits within
  ``LOGIT_ATOL``, greedy tokens identical at stages 1, 4 and 8;
  ``SpeculativeEngine`` at stage 8: tokens identical to the reference's
  and to the port's plain greedy tokens;
* ``Model.grow_caches`` pads a ``selfcross`` block's ``self`` part only;
* refusals: the slot pool ("encoder-decoder"), a ``prefill_chunk`` over
  a ``selfcross`` block; a serving mesh of 2 logical shards serves, its
  tokens those of one device; the CLI serves ``--arch
  seamless-m4t-medium --reduced``, with ``--mesh-shards 2`` too.

The reference's division, engines and speculation run in processes of
their own (:class:`Reference`, one a job), started with the module's
fixture; ``tests/test_torch_vision.py`` runs llama-3.2-vision-90b's jobs
the same way.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.progressive import ReceiverState, divide, tree_flatten_with_path
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build_model
from repro_torch.serving import (ProgressiveServer, SlotPoolEngine, SpecConfig,
                                 SpeculativeEngine)
from repro_torch.transmission import ProgressiveClient
import test_torch_recurrent as rec
from test_torch_recurrent import (ATOL, CHECK_STAGES, LOGIT_ATOL, MAX_LEN, RTOL, SIZE, STEPS,
                                  _close, _np, _numpy_weights, _prompt, check_config,
                                  check_division)

PROMPT = 20
SPEC = dict(draft_bits=4, k=2)

# The reference side: as test_torch_recurrent's script, with each
# request's memory input ("enc_input" or "vision_embeds", from the npz
# under "memory") passed to the engines, and three more jobs: "spec" runs
# SpeculativeEngine at stage 8; "pool" runs SlotPoolEngine with the
# requests' extras ("image/<rid>"), an upgrade a window; "specpool" runs
# SpeculativeSlotPool on them at stage 8.
_REFERENCE = """
    import json, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import wire
    from repro.core.bitplanes import PlaneSchedule
    from repro.core.policy import TensorPlan
    from repro.core.progressive import (ProgressiveModel, ReceiverState, TensorPlanes,
                                        divide)
    from repro.models.model import build_model
    from repro.serving.engine import PoolRequest, ProgressiveServer, SlotPoolEngine
    from repro.serving.speculative import SpecConfig, SpeculativeEngine, SpeculativeSlotPool

    inp, job = np.load(sys.argv[1]), sys.argv[3]
    spec = json.loads(str(inp["spec"]))
    model = build_model(get_config(spec["name"]).reduced(**spec["over"]))

    def leaf(path, shape):
        return jnp.asarray(inp["param/" + wire.path_str(path)])

    params = jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(model.init,
                                                                   jax.random.PRNGKey(0)))
    out = {}
    stages = spec["stages"]
    batch = {"tokens": jnp.asarray(inp["tokens"]), spec["memory"]: jnp.asarray(inp["memory"])}
    if job == "division":
        prog = divide(params)
    else:
        # the port's planes (the division job holds their bytes to the
        # reference's own), as the reference's divided model
        meta = json.loads(str(inp["prog"]))
        leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
        by_path = {wire.path_str(p): (p, a) for p, a in leaves}
        tensors = []
        for i, m in enumerate(meta["tensors"]):
            path, a = by_path[m["path"]]
            plan = TensorPlan(schedule=PlaneSchedule(m["bits"], tuple(m["widths"])),
                              priority=m["priority"])
            tensors.append(TensorPlanes(
                path=path, plan=plan, lo=jnp.asarray(inp[f"lo/{i}"]),
                hi=jnp.asarray(inp[f"hi/{i}"]), shape=tuple(a.shape), orig_dtype=a.dtype,
                planes=[jnp.asarray(inp[f"plane/{i}/{j}"]) for j in range(len(m["widths"]))]))
        prog = ProgressiveModel(tensors=tensors, treedef=treedef, n_stages=meta["n_stages"],
                                passthrough=[])

    def requests():
        for rid, budget in enumerate(spec["budgets"]):
            yield PoolRequest(rid=rid, prompt=inp[f"prompt/{rid}"], max_new_tokens=budget,
                              extras={"vision_embeds": inp[f"image/{rid}"]})

    if job == "division":
        out["order"] = np.asarray(json.dumps([[i for i, _ in prog.stage(s)]
                                              for s in range(1, prog.n_stages + 1)]))
        out["paths"] = np.asarray(json.dumps([wire.path_str(t.path) for t in prog.tensors]))
        for i, t in enumerate(prog.tensors):
            out[f"lo/{i}"], out[f"hi/{i}"] = np.asarray(t.lo), np.asarray(t.hi)
            for j, plane in enumerate(t.planes):
                out[f"plane/{i}/{j}"] = np.asarray(plane)
    elif job == "encode":
        out["blob"] = np.frombuffer(wire.encode(prog, integrity=True), np.uint8)
    elif job == "receiver":
        st = ReceiverState.init(prog)
        for s in range(1, prog.n_stages + 1):
            st = st.receive(prog.stage(s))
            if s in stages:
                out[f"fp/{s}"] = np.asarray(json.dumps(st.store.fingerprint()))
                for k, v in st.store.buffers.items():
                    out[f"buffer/{s}/{k}"] = np.asarray(v)
        for path, a in jax.tree_util.tree_flatten_with_path(st.materialize())[0]:
            out["leaf/" + wire.path_str(path)] = np.asarray(a)
    elif job.startswith("server/"):
        resident = job.split("/")[1]
        srv = ProgressiveServer(model, prog, max_len=spec["max_len"], resident=resident)
        for s in range(1, prog.n_stages + 1):
            srv.receive_stage()
            if s not in stages:
                continue
            srv.start(batch)
            out[f"{s}/first"] = np.asarray(srv.last_logits)
            out[f"{s}/tokens"] = np.asarray(srv.decode(spec["steps"]).tokens)
            out[f"{s}/last"] = np.asarray(srv.last_logits)
        out["report"] = np.asarray(json.dumps(srv.resident_report()))
    elif job == "spec":
        eng = SpeculativeEngine(model, prog, max_len=spec["max_len"],
                                spec=SpecConfig(**spec["spec"]))
        for _ in range(prog.n_stages):
            eng.receive_stage()
        eng.start(batch)
        out["tokens"] = np.asarray(eng.decode(spec["steps"]).tokens)
    elif job == "pool":
        pool = SlotPoolEngine(model, prog, **spec["pool"])
        pool.receive_stage()
        for req in requests():
            pool.submit(req)
        res = pool.run(on_window=lambda _: pool.upgrade_if_available())
        out["run"] = np.asarray(json.dumps({
            "out": {rid: list(map(int, t)) for rid, t in res.items()},
            "stage_log": pool.stage_log, "admit_stage": pool.admit_stage,
            "upgrades": pool.upgrades, "chunked": pool.chunked_prefill}))
    elif job == "specpool":
        pool = SpeculativeSlotPool(model, prog, spec=SpecConfig(**spec["spec"]),
                                   **spec["specpool"])
        for _ in range(prog.n_stages):
            pool.receive_stage()
        for req in requests():
            pool.submit(req)
        res = pool.run()
        out["run"] = np.asarray(json.dumps({
            "out": {rid: list(map(int, t)) for rid, t in res.items()},
            "chunked": pool.chunked_prefill}))
    np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cross_weights(model, seed=0) -> dict:
    """``_numpy_weights`` with every LayerNorm bias spread around 0 and
    every ``cross`` block's gates drawn away from 0: the reference starts
    them at 0, where ``tanh(0)`` adds nothing of the cross path."""
    out = _numpy_weights(model, seed)
    rng = np.random.default_rng(seed + 100)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "bias":
                node[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k in ("gate_attn", "gate_mlp"):
                node[k] = (rng.choice([-1.0, 1.0], v.shape)
                           * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
    walk(out)
    return out


def memory_input(cfg, seed, batch, prompt_len):
    """A cross-attention arch's memory input from numpy: (key, array)."""
    rng = np.random.default_rng(seed)
    if cfg.enc_layers:
        shape = (batch, max(1, prompt_len // cfg.enc_seq_divisor), cfg.d_model)
        return "enc_input", rng.standard_normal(shape).astype(np.float32)
    return "vision_embeds", rng.standard_normal(
        (batch, cfg.vision_tokens, cfg.d_vision)).astype(np.float32)


def start_cross(tmp, name: str, jobs, *, spec=None, **inputs) -> dict:
    """The port's model over :func:`cross_weights`, divided by the default
    policy, and the reference's jobs on the same weights and inputs,
    started (``test_torch_recurrent.Reference`` with this module's
    script)."""
    cfg = get_config(name).reduced(**SIZE)
    model = build_model(cfg)
    weights = cross_weights(model)
    params = params_from_numpy(weights, device="cpu")
    tokens = _prompt(1, (2, PROMPT))
    key, memory = memory_input(cfg, 2, 2, PROMPT)
    prog = divide(params)
    inputs.update(tokens=tokens, memory=memory, prog=json.dumps({
        "n_stages": prog.n_stages, "tensors": [
            {"path": "/".join(t.path), "bits": t.plan.schedule.bits,
             "widths": list(t.plan.schedule.widths), "priority": t.plan.priority}
            for t in prog.tensors]}))
    inputs["spec"] = {"memory": key, "spec": SPEC, **(spec or {})}
    for i, t in enumerate(prog.tensors):
        inputs[f"lo/{i}"], inputs[f"hi/{i}"] = t.lo.numpy(), t.hi.numpy()
        for j, plane in enumerate(t.planes):
            inputs[f"plane/{i}/{j}"] = plane.numpy()
    ref = rec.Reference(tmp, name, {}, weights, jobs, script=_REFERENCE, **inputs)
    return dict(cfg=cfg, model=model, params=params, prog=prog, ref=ref, tokens=tokens,
                batch={"tokens": tokens, key: memory})


@pytest.fixture(scope="module")
def seamless(tmp_path_factory):
    a = start_cross(tmp_path_factory.mktemp("seamless"), "seamless-m4t-medium",
                    ["division", "encode", "receiver", "server/quantized", "server/fp",
                     "spec"])
    yield a
    a["ref"].close()


def test_config_equals_reference(seamless):
    """(Takes the fixture first, which starts the reference's jobs.)"""
    flat = check_config("seamless-m4t-medium", {})
    cfg = get_config("seamless-m4t-medium")
    assert (cfg.enc_layers, cfg.enc_seq_divisor, cfg.cycle) == (12, 4, ("selfcross",))
    assert cfg.uses_cross and not get_config("olmo-1b").uses_cross
    assert flat[("encoder", "stack", "cycles", "0_enc_attn", "attn", "wq")] == (2, 64, 64)
    assert flat[("encoder", "final_norm", "bias")] == (64,)
    assert flat[("decoder", "cycles", "0_selfcross", "cross_attn", "wk")] == (2, 64, 32)
    assert flat[("decoder", "cycles", "0_selfcross", "norm_x", "scale")] == (2, 64)


# ---------------------------------------------------------------------------
# the attention functions against the reference
# ---------------------------------------------------------------------------

def _x(seed, shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _attn_params(cfg, seed):
    """One attention's weights (with ``q_norm``/``k_norm`` spread around 1
    under ``qk_norm``), numpy, torch and jax."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.hd
    p = {"wq": _x(seed + 1, (d, cfg.n_heads * hd), 0.2), "wk": _x(seed + 2, (d, cfg.n_kv * hd), 0.2),
         "wv": _x(seed + 3, (d, cfg.n_kv * hd), 0.2), "wo": _x(seed + 4, (cfg.n_heads * hd, d), 0.2)}
    if cfg.qk_norm:
        p["q_norm"] = (1 + 0.2 * rng.standard_normal(hd)).astype(np.float32)
        p["k_norm"] = (1 + 0.2 * rng.standard_normal(hd)).astype(np.float32)
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def _cfgs(qk_norm: bool):
    over = dict(SIZE, qk_norm=qk_norm)
    return (get_config("seamless-m4t-medium").reduced(**over),
            jax_get_config("seamless-m4t-medium").reduced(**over))


def test_chunked_attention_noncausal_equals_reference():
    """37 queries over 37 keys in chunks of 16 (a ragged last chunk), two
    keys invalid (negative positions), G = 2; and the causal default
    unchanged against the reference's."""
    q, k, v = _x(1, (2, 37, 4, 16), 1.0), _x(2, (2, 37, 2, 16), 1.0), _x(3, (2, 37, 2, 16), 1.0)
    pos = np.arange(37, dtype=np.int32)
    kpos = pos.copy()
    kpos[[3, 30]] = -1
    for causal in (False, True):
        want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(pos), jnp.asarray(kpos), causal=causal,
                                       chunk=16)
        got = attn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), torch.from_numpy(pos),
                                     torch.from_numpy(kpos), causal=causal, chunk=16)
        _close(np.asarray(want), got, msg=f"causal={causal}")


@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("mode,Tq", [("prefill", 1), ("prefill", 5), ("decode", 1),
                                     ("verify", 5)])
def test_cross_attention_equals_reference(mode, Tq, qk_norm):
    """A memory of Tv = 21 frames (two chunks of 16): projected by
    ``cross_kv``, attended chunked (``native=False``) or, from the native
    cache ``to_native_kv`` makes, through ``ops.decode_attention``
    (Tq = 1) or ``ops.verify_attention`` (Tq = 5) with every row at
    ``q_pos = Tv``; against the reference's functions."""
    cfg, jcfg = _cfgs(qk_norm)
    p, jp = _attn_params(cfg, 10)
    x, mem = _x(20, (2, Tq, cfg.d_model)), _x(21, (2, 21, cfg.d_model))
    jkv = jattn.cross_kv(jcfg, jp, jnp.asarray(mem))
    kv = attn.cross_kv(cfg, p, torch.from_numpy(mem))
    native = mode != "prefill"
    if native:
        jkv, kv = jattn.to_native_kv(jkv), attn.to_native_kv(kv)
        assert kv["k"].shape == (2, cfg.n_kv, 21, cfg.hd) and kv["k"].is_contiguous()
    want = jattn.cross_attention(jcfg, jp, jnp.asarray(x), jkv, native=native)
    got = attn.cross_attention(cfg, p, torch.from_numpy(x), kv, native=native,
                               rows="decode" if native else "any")
    _close(np.asarray(want), got)


@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
def test_cross_kv_equals_reference(qk_norm):
    cfg, jcfg = _cfgs(qk_norm)
    p, jp = _attn_params(cfg, 30)
    mem = _x(31, (3, 7, cfg.d_model))
    want = jattn.cross_kv(jcfg, jp, jnp.asarray(mem))
    got = attn.cross_kv(cfg, p, torch.from_numpy(mem))
    for name in ("k", "v"):
        _close(np.asarray(want[name]), got[name], msg=name)


def _block(kind, seed):
    """One block of ``kind`` from the port's seeded init, spread as
    :func:`cross_weights` spreads a model's, in both packages."""
    cfg = get_config("seamless-m4t-medium").reduced(**SIZE)
    jcfg = jax_get_config("seamless-m4t-medium").reduced(**SIZE)
    tree = {"b": {k: v for k, v in tree_flatten_with_path(
        tfm.block_init(cfg, torch.Generator().manual_seed(seed), kind, device="cpu"))}}
    nested: dict = {}
    for path, t in tree["b"].items():
        node = nested
        for k in path[:-1]:
            node = node.setdefault(k, {})
        rng = np.random.default_rng(seed + len(path))
        a = t.numpy()
        if path[-1] == "scale":
            a = a + 0.2 * rng.standard_normal(a.shape)
        elif path[-1] == "bias":
            a = a + 0.1 * rng.standard_normal(a.shape)
        node[path[-1]] = a.astype(np.float32)
    return (cfg, jcfg, params_from_numpy(nested, device="cpu"),
            jax.tree.map(jnp.asarray, nested))


def test_enc_attn_block_equals_reference():
    """An ``enc_attn`` block over 37 frames (three chunks of 16): rope at
    0..36, attention over every frame, the MLP; no cache."""
    cfg, jcfg, p, jp = _block("enc_attn", 40)
    x = _x(41, (2, 37, cfg.d_model), 1.0)
    want, jc, _ = jtfm.block_apply(jcfg, "enc_attn", jp, jnp.asarray(x), mode="full",
                                   cache=None, pos=None, enc_out=None)
    got, c, aux = tfm.block_apply(cfg, "enc_attn", p, torch.from_numpy(x), mode="full",
                                  cache=None, pos=None)
    assert jc is None and c is None and aux is None
    _close(np.asarray(want), got)


def test_selfcross_block_prefill_and_decode_equal_reference():
    """A ``selfcross`` block's prefill over 9 tokens and a memory of 5
    frames, then a decode step and a verify block of 3 over its caches:
    outputs and caches against the reference's block."""
    cfg, jcfg, p, jp = _block("selfcross", 50)
    x, mem = _x(51, (2, 9, cfg.d_model), 1.0), _x(52, (2, 5, cfg.d_model), 1.0)
    want, jc, _ = jtfm.block_apply(jcfg, "selfcross", jp, jnp.asarray(x), mode="prefill",
                                   cache=None, pos=None, enc_out=jnp.asarray(mem))
    got, c, _ = tfm.block_apply(cfg, "selfcross", p, torch.from_numpy(x), mode="prefill",
                                cache=None, pos=None, enc_out=torch.from_numpy(mem))
    _close(np.asarray(want), got, msg="prefill")
    for part in ("self", "cross"):
        for name in ("k", "v"):
            _close(np.asarray(jc[part][name]), c[part][name], msg=f"prefill {part} {name}")
    # room for the decode step and the verify block
    jc = {"self": jax.tree.map(lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, 7), (0, 0))),
                               jc["self"]), "cross": jc["cross"]}
    c = {"self": {k: torch.nn.functional.pad(v, (0, 0, 0, 7)) for k, v in c["self"].items()},
         "cross": c["cross"]}
    for mode, T, pos in (("decode", 1, 9), ("verify", 3, 10)):
        xs = _x(53 + T, (2, T, cfg.d_model), 1.0)
        want, jc, _ = jtfm.block_apply(jcfg, "selfcross", jp, jnp.asarray(xs), mode=mode,
                                       cache=jc, pos=jnp.asarray([pos, pos], jnp.int32),
                                       enc_out=None)
        got, c, _ = tfm.block_apply(cfg, "selfcross", p, torch.from_numpy(xs), mode=mode,
                                    cache=c, pos=torch.tensor([pos, pos], dtype=torch.int32))
        _close(np.asarray(want), got, msg=mode)
        _close(np.asarray(jc["self"]["k"]), c["self"]["k"], msg=f"{mode} self k")


@pytest.mark.parametrize("mode,T,fn", [("decode", 1, "decode_attention"),
                                        ("verify", 3, "verify_attention")])
def test_memory_positions_built_once_a_step(seamless, monkeypatch, mode, T, fn):
    """A decode step and a verify block over the reduced model's two
    ``selfcross`` layers: every cross launch reads the same ``k_pos`` and
    ``q_pos`` tensors (the first cross layer builds them, the others
    reuse them), ``arange(Tv)`` and ``Tv`` on every row, and the logits
    equal those of each layer building its own."""
    a = seamless
    model = a["model"]
    params = ReceiverState.init(a["prog"], device="cpu").receive(a["prog"].stage(8)).materialize()
    batch = {k: torch.from_numpy(v) for k, v in a["batch"].items()}
    Tv = model.enc_len(PROMPT)
    tokens = torch.from_numpy(_prompt(7, (2, T)))

    def step(caches):
        if mode == "decode":
            return model.decode_step(params, caches, tokens, PROMPT)[0]
        return model.verify_step(params, caches, tokens, PROMPT)[0]

    def fresh():
        _, caches = model.prefill(params, batch)
        return model.grow_caches(caches, MAX_LEN)

    seen, launch = [], getattr(attn.ops, fn)

    def spy(q, k, v, k_pos, q_pos, *args, **kw):
        if k.shape[2] == Tv:
            seen.append((k_pos, q_pos))
        return launch(q, k, v, k_pos, q_pos, *args, **kw)

    monkeypatch.setattr(attn.ops, fn, spy)
    shared = step(fresh())
    assert len(seen) == a["cfg"].n_layers
    assert all(kp is seen[0][0] and qp is seen[0][1] for kp, qp in seen)
    kp, qp = seen[0]
    assert torch.equal(kp, torch.arange(Tv, dtype=torch.int32).expand(2, Tv))
    assert qp.shape == ((2,) if T == 1 else (2, T)) and bool((qp == Tv).all())
    real = attn.cross_attention
    monkeypatch.setattr(attn, "cross_attention",
                        lambda *args, positions=None, **kw: real(*args, **kw))
    assert torch.equal(step(fresh()), shared)


@pytest.mark.parametrize("name,want", [
    ("seamless-m4t-medium", ("enc_input", (PROMPT // 4, 64))),
    ("llama-3.2-vision-90b", ("vision_embeds", (16, 64))),
    ("olmo-1b", None)])
def test_memory_input_names_key_and_shape(name, want):
    """``ArchConfig.memory_input`` names the batch key and per-request
    shape that ``Model.enc_len``, the CLI's ``build_batch`` and the pool's
    ``extras`` check all read; a prompt shorter than the divisor still
    has one frame."""
    cfg = get_config(name).reduced(**SIZE)
    assert cfg.memory_input(PROMPT) == want
    batch = serve.build_batch(cfg, 3, PROMPT, seed=0)
    assert sorted(batch) == sorted(["tokens"] + ([want[0]] if want else []))
    if want:
        assert batch[want[0]].shape == (3, *want[1]) and not batch[want[0]].any()
    assert build_model(cfg).enc_len(PROMPT) == (want[1][0] if want else 0)
    if cfg.enc_layers:
        assert cfg.memory_input(3) == ("enc_input", (1, 64))


# ---------------------------------------------------------------------------
# the division, serving and speculation against the reference's
# ---------------------------------------------------------------------------

def test_division_equals_reference(seamless):
    prog = check_division(seamless)
    paths = ["/".join(t.path) for t in prog.tensors]
    assert "encoder/stack/cycles/0_enc_attn/attn/wq" in paths
    assert "decoder/cycles/0_selfcross/cross_attn/wv" in paths


def check_server(a, resident):
    """At stages 1, 4 and 8 from a fresh start with the batch's memory
    input: the prefill's logits, then ``STEPS`` greedy steps; logits
    within ``LOGIT_ATOL`` and tokens identical to the reference's; the
    resident report equal."""
    ref = a["ref"][f"server/{resident}"]
    srv = ProgressiveServer(a["model"], a["prog"], max_len=MAX_LEN, resident=resident,
                            device="cpu")
    for s in range(1, 9):
        srv.receive_stage()
        if s not in CHECK_STAGES:
            continue
        srv.start(a["batch"])
        _close(ref[f"{s}/first"], srv.last_logits, 0, LOGIT_ATOL, f"stage {s}")
        res = srv.decode(STEPS)
        np.testing.assert_array_equal(_np(res.tokens), ref[f"{s}/tokens"], f"stage {s}")
        _close(ref[f"{s}/last"], srv.last_logits, 0, LOGIT_ATOL, f"stage {s}")
    assert json.loads(json.dumps(srv.resident_report())) == json.loads(str(ref["report"]))
    return srv


@pytest.mark.parametrize("resident", ["quantized", "fp"])
def test_server_logits_and_tokens_every_stage(seamless, resident):
    srv = check_server(seamless, resident)
    if resident == "quantized":
        # the memory's projections are B2 launches on quantized views
        assert "['decoder']['cycles']['0_selfcross']['cross_attn']['wk']" in \
            srv.resident_report()["effective_bits"]


def check_speculative(a):
    """``SpeculativeEngine`` at stage 8 from the batch (memory included):
    tokens identical to the reference's engine and to the port's plain
    greedy tokens over the same views."""
    eng = SpeculativeEngine(a["model"], a["prog"], max_len=MAX_LEN, spec=SpecConfig(**SPEC),
                            device="cpu")
    plain = ProgressiveServer(a["model"], a["prog"], max_len=MAX_LEN, resident="quantized",
                              device="cpu")
    for _ in range(8):
        eng.receive_stage()
        plain.receive_stage()
    eng.start(a["batch"])
    plain.start(a["batch"])
    res = eng.decode(STEPS)
    np.testing.assert_array_equal(_np(res.tokens), a["ref"]["spec"]["tokens"])
    np.testing.assert_array_equal(_np(res.tokens), _np(plain.decode(STEPS).tokens))
    assert res.drafted > 0
    return eng


def test_speculative_equals_reference_and_plain(seamless):
    check_speculative(seamless)


def test_grow_caches_pads_self_only(seamless):
    """A prefill's ``selfcross`` caches grown to ``MAX_LEN``: the self part
    padded (rows past the prompt zero), the cross part the same tensors."""
    a = seamless
    params = ReceiverState.init(a["prog"], device="cpu").receive(a["prog"].stage(1)).materialize()
    batch = {k: torch.from_numpy(v) for k, v in a["batch"].items()}
    _, caches = a["model"].prefill(params, batch)
    grown = a["model"].grow_caches(caches, MAX_LEN)
    c, g = caches["cycles"]["0_selfcross"], grown["cycles"]["0_selfcross"]
    assert g["cross"]["k"] is c["cross"]["k"] and g["cross"]["v"] is c["cross"]["v"]
    assert c["cross"]["k"].shape == (2, 2, 2, PROMPT // 4, 16)
    assert g["self"]["k"].shape == (2, 2, 2, MAX_LEN, 16)
    assert torch.equal(g["self"]["k"][..., :PROMPT, :], c["self"]["k"])
    assert not g["self"]["v"][..., PROMPT:, :].any()
    assert a["model"].enc_len(PROMPT) == 5 and a["model"].enc_len(3) == 1


# ---------------------------------------------------------------------------
# refusals and the CLI
# ---------------------------------------------------------------------------

def test_refusals(seamless):
    model, prog = seamless["model"], seamless["prog"]
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        SlotPoolEngine(model, prog, n_slots=2, max_len=MAX_LEN, device="cpu")
    params = ReceiverState.init(prog, device="cpu").receive(prog.stage(1)).materialize()
    caches = model.init_caches(2, MAX_LEN, device="cpu")
    with pytest.raises(NotImplementedError, match="chunked prefill is not supported for "
                                                  "selfcross blocks"):
        model.prefill_chunk(params, caches, torch.zeros((2, 4), dtype=torch.int64),
                            torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="enc_input"):
        model.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.int64)})
    # a serving mesh is no refusal: the sharded server, speculation and
    # client serve (tests/test_torch_sharded_families.py holds them)
    mesh = make_serving_mesh(2, devices=["cpu"] * 2)
    key, memory = memory_input(model.cfg, 2, 2, 8)
    batch = {"tokens": _prompt(1, (2, 8)), key: memory}
    tokens = {}
    for m in (None, mesh):
        srv = ProgressiveServer(model, prog, max_len=MAX_LEN, mesh=m, device="cpu")
        srv.receive_stage()
        srv.start(batch)
        tokens[m is None] = srv.decode(4).tokens
    assert torch.equal(tokens[False], tokens[True])
    SpeculativeEngine(model, prog, max_len=MAX_LEN, mesh=mesh, device="cpu")
    client = ProgressiveClient(mesh=mesh, device="cpu")
    client.feed(wire.encode(prog))
    assert client.complete


@pytest.mark.parametrize("mode", ["default", "quantized", "speculative"])
def test_cli_seamless_reduced(mode, capsys):
    """``--arch seamless-m4t-medium --reduced`` serves (zeros as the frames,
    as the reference launcher makes them)."""
    argv = ["--arch", "seamless-m4t-medium", "--reduced", "--device", "cpu",
            "--decode-steps", "8"]
    serve.main(argv + {"default": [], "quantized": ["--resident", "quantized"],
                       "speculative": ["--speculative", "--draft-k", "2"]}[mode])
    # speculation emits several tokens a round, so it may finish before stage 8
    assert "served 8 steps across" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [(["--pool-clients", "2"], "encoder-decoder"),
                                         (["--mesh-shards", "2"], None)],
                         ids=["pool", "mesh_shards"])
def test_cli_refusals(flags, match, capsys):
    """``--pool-clients`` raises; ``--mesh-shards 2`` serves, token for
    token the run without it."""
    argv = ["--arch", "seamless-m4t-medium", "--reduced", "--device", "cpu"]
    if match is None:
        rec.cli_tokens(argv + ["--decode-steps", "6", "--resident", "quantized"], flags, capsys)
        return
    with pytest.raises(NotImplementedError, match=match):
        serve.main(argv + flags)
