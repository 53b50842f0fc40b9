"""Sharded serving of the recurrent and cross-attention archs in the port
against the JAX package, on the CPU.

xlstm-125m (one sLSTM and one mLSTM block), zamba2-7b at 13 layers (two
cycles of five Mamba-2 blocks and the shared attention block, so both uses
of ``decoder/shared`` run, and a Mamba-2 tail), seamless-m4t-medium (2
``enc_attn`` encoder and 2 ``selfcross`` decoder blocks) and
llama-3.2-vision-90b (four ``attn`` blocks and a gated ``cross`` block,
its gates drawn away from 0), as ``reduced()`` gives them at d_model 64,
vocab 256, float32, the same numpy-made weights in both packages
(``tests/test_torch_cross.cross_weights``). Meshes of ``["cpu"] * n``
logical shards.

The split leaves that the recurrences read elementwise (a Mamba-2 block's
``conv_w``, split on d_inner; an sLSTM block's ``r``, split on 4 hd) are
gathered whole on the home device (``launch.sharding.GATHERED_LEAVES``);
the reference reads them whole through GSPMD's gather.

The reference's side runs in two subprocesses an arch, all started with
the module's fixture, each with eight forced host devices, reading the
port's v3 bytes (the per-family tests hold them equal to the reference's
own division of these weights). Held exactly, at
n = 2, 3 and 4, for the v3 bytes fed in ragged chunks to
``ProgressiveClient(mesh=)``: routes, placement, per-shard fingerprints
after every stage, every ``acc(i)``, and every float and quantized leaf
gathered. The reference's sharded engines do not run on the installed
JAX, so serving is held against its single-device ``Session.run_serving``
(quantized, with ``enc_input`` or ``vision_embeds``): the port's sharded
session at n = 2 gives the same tokens and per-step stages. The port's
sharded pool (xlstm-125m and zamba2-7b with chunked admission,
llama-3.2-vision-90b at batch 1 with an image a request),
``SpeculativeEngine`` (the cross archs) and float-resident server give
the tokens of its own single-device engines, which the per-family tests
hold against the reference; quantized logits within B2's CPU tolerance
(rtol 2e-5, atol 2e-4, as ``tests/test_torch_kernels.py``). A
``ShardedLeaf`` forced into an elementwise read raises ``TypeError``
naming the leaf.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.plane_store import ShardedLeaf, ShardedPlaneStore, _path
from repro_torch.core.progressive import divide, tree_flatten_with_path
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.model import build_model
from repro_torch.serving import (PoolRequest, ProgressiveServer, SlotPoolEngine, SpecConfig,
                                 SpeculativeEngine)
from repro_torch.serving.engine import WireStoreReceiver
from repro_torch.transmission import ProgressiveClient, Session, get_scenario
from test_torch_cross import cross_weights, memory_input

XLSTM, ZAMBA, SEAMLESS, VISION = ("xlstm-125m", "zamba2-7b", "seamless-m4t-medium",
                                  "llama-3.2-vision-90b")
ARCHS = (XLSTM, ZAMBA, SEAMLESS, VISION)
REDUCED = {XLSTM: dict(d_model=64, vocab=256), ZAMBA: dict(d_model=64, vocab=256, n_layers=13),
           SEAMLESS: dict(d_model=64, vocab=256), VISION: dict(d_model=64, vocab=256)}
SHARDS = (2, 3, 4)
N_CUTS = 12
STEPS = 12
# B2 on the CPU: a shard's columns summed apart from the others
RTOL, ATOL = 2e-5, 2e-4
TOKENS = np.random.default_rng(1).integers(0, 256, (2, 8)).astype(np.int32)

# The reference side, two processes an arch (``JOBS``: the store at n = 2
# and 3; at n = 4 and the session). The per-family tests hold the
# port's division and v3 bytes equal to the reference's on these archs
# (``test_torch_recurrent.check_division``), so the reference reads the
# port's bytes, fed in the port's ragged chunks to its sharded client at
# n = 2, 3 and 4, and runs its single-device quantized session on them
# with the arch's memory input, over the port's divided model's metadata
# (a session's server reads its planes from the client, not the model).
_REFERENCE = """
    import json, os, sys
    # XLA's backend optimisation off: these small runs are compile-bound
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "--xla_backend_optimization_level=0 "
                               "--xla_llvm_disable_expensive_passes=true")
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import wire
    from repro.core.bitplanes import PlaneSchedule
    from repro.core.policy import TensorPlan
    from repro.core.progressive import ProgressiveModel, TensorPlanes
    from repro.launch.mesh import make_serving_mesh
    from repro.models.model import build_model
    from repro.transmission import ProgressiveClient, Session, get_scenario

    inp, (name, part) = np.load(sys.argv[1]), sys.argv[3].split(":")
    model = build_model(get_config(name).reduced(**json.loads(str(inp["reduced"]))[name]))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    by_path = {wire.path_str(p): (p, a) for p, a in leaves}
    meta = json.loads(str(inp[f"{name}/prog"]))
    tensors = []
    for i, m in enumerate(meta["tensors"]):
        path, a = by_path[m["path"]]
        tensors.append(TensorPlanes(
            path=path, plan=TensorPlan(schedule=PlaneSchedule(m["bits"], tuple(m["widths"])),
                                       priority=m["priority"]),
            lo=jnp.asarray(inp[f"{name}/lo/{i}"]), hi=jnp.asarray(inp[f"{name}/hi/{i}"]),
            shape=tuple(a.shape), orig_dtype=a.dtype, planes=[]))
    prog = ProgressiveModel(tensors=tensors, treedef=treedef, n_stages=meta["n_stages"],
                            passthrough=[])
    blob = inp[f"{name}/blob"].tobytes()
    out = {}
    ends = {int(e) for e in inp[f"{name}/ends"]}
    for n in [int(n) for n in part.split(",") if n != "serve"]:
        client, prev, fps = ProgressiveClient(mesh=make_serving_mesh(n)), 0, {}
        for c in [int(c) for c in inp[f"{name}/cuts"]]:
            client.feed(blob[prev:c])
            prev = c
            if c in ends:
                fps[client.stages_complete] = client.store.fingerprint()
        st = client.store
        out[f"{n}/fps"] = np.asarray(json.dumps(fps))
        out[f"{n}/placement"] = np.asarray(json.dumps(st._placement))
        out[f"{n}/route"] = np.asarray(json.dumps(st._route))
        # one device_get for every array of the store
        got = jax.device_get({
            "acc": [st.acc(i) for i in range(st.n_tensors)],
            "fp": st.materialize_leaves(),
            "q": {k: {f: getattr(v, f) for f in ("q", "scale", "offset", "received_bits")}
                  if hasattr(v, "q") else v for k, v in st.quantized_leaves().items()}})
        for i, a in enumerate(got["acc"]):
            out[f"{n}/acc/{i}"] = a
        for k, v in got["fp"].items():
            out[f"{n}/fp/{k}"] = v
        for k, v in got["q"].items():
            for f in ("q", "scale", "offset", "received_bits"):
                out[f"{n}/q/{k}/{f}"] = v[f] if isinstance(v, dict) else v
    if "serve" in part:
        batch = {"tokens": jnp.asarray(inp["tokens"])}
        if f"{name}/memory" in inp:
            batch[str(inp[f"{name}/memory_key"])] = jnp.asarray(inp[f"{name}/memory"])
        res = Session.from_scenario(blob, get_scenario("browser-lte-handoff"), seed=1
                                    ).run_serving(model, prog, decode_steps=int(inp["steps"]),
                                                  batch=batch, resident="quantized")
        out["serve/tokens"] = np.asarray(res.tokens)
        out["serve/stages"] = np.asarray(res.stage_at_step)
    np.savez(sys.argv[2], **out)
"""

JOBS = tuple(f"{name}:{part}" for name in ARCHS for part in ("2,3", "4,serve"))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stage_ends(blob) -> list[int]:
    meta, hdr = wire.decode_header(blob)
    return np.cumsum([hdr] + wire.layout_from_header(meta, hdr).stage_bytes).tolist()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's models, programs, blobs, ragged cuts and memory inputs
    by arch; the reference's processes, started here and read by
    :func:`_reference`."""
    tmp = tmp_path_factory.mktemp("sharded_families")
    inp = {"reduced": json.dumps(REDUCED), "steps": STEPS, "tokens": TOKENS}
    models, progs, blobs, cuts, batches = {}, {}, {}, {}, {}
    rng = np.random.default_rng(5)
    for name, over in REDUCED.items():
        cfg = get_config(name).reduced(**over)
        models[name] = build_model(cfg)
        progs[name] = prog = divide(params_from_numpy(cross_weights(models[name]),
                                                      device="cpu"))
        blobs[name] = wire.encode(prog, integrity=True)
        inp[f"{name}/blob"] = np.frombuffer(blobs[name], np.uint8)
        inp[f"{name}/prog"] = json.dumps({"n_stages": prog.n_stages, "tensors": [
            {"path": "/".join(t.path), "bits": t.plan.schedule.bits,
             "widths": list(t.plan.schedule.widths), "priority": t.plan.priority}
            for t in prog.tensors]})
        for i, t in enumerate(prog.tensors):
            inp[f"{name}/lo/{i}"], inp[f"{name}/hi/{i}"] = t.lo.numpy(), t.hi.numpy()
        ends = _stage_ends(blobs[name])
        ragged = rng.choice(np.arange(1, len(blobs[name])), N_CUTS, replace=False)
        cuts[name] = sorted(set(ragged.tolist()) | set(ends[1:]))
        inp[f"{name}/cuts"], inp[f"{name}/ends"] = np.asarray(cuts[name]), np.asarray(ends[1:])
        batches[name] = {"tokens": TOKENS}
        if cfg.uses_cross:
            key, memory = memory_input(cfg, 2, *TOKENS.shape)
            batches[name][key] = memory
            inp[f"{name}/memory_key"], inp[f"{name}/memory"] = key, memory
    np.savez(tmp / "in.npz", **inp)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for job in JOBS:
        tag = job.replace(":", "_").replace(",", "_")
        with open(tmp / f"{tag}.err", "w") as err:
            procs[job] = subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(tmp / "in.npz"),
                 str(tmp / f"{tag}.npz"), job], stdout=subprocess.DEVNULL, stderr=err,
                env=env)
    world = {"models": models, "progs": progs, "blobs": blobs, "cuts": cuts,
             "batches": batches, "tmp": tmp, "procs": procs, "out": {}}
    yield world
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _reference(world, name: str) -> dict:
    """An arch's reference results, both its jobs': waits for their
    processes the first time."""
    if name not in world["out"]:
        out = {}
        for job in JOBS:
            if job.startswith(f"{name}:"):
                tag = job.replace(":", "_").replace(",", "_")
                rc = world["procs"][job].wait(timeout=240)
                assert rc == 0, (world["tmp"] / f"{tag}.err").read_text()[-3000:]
                out.update(np.load(world["tmp"] / f"{tag}.npz"))
        world["out"][name] = out
    return world["out"][name]


def _mesh(n: int):
    return make_serving_mesh(n, devices=["cpu"] * n)


def _gathered(leaf):
    return leaf.gather() if isinstance(leaf, ShardedLeaf) else leaf


def _json(arr) -> object:
    return json.loads(str(arr))


# ---------------------------------------------------------------------------
# the port against itself (while the reference's processes run)
# ---------------------------------------------------------------------------

def _server(world, name, mesh, resident, wire_fed=False):
    """The single stream, a stage every other step: pulled from the divided
    model, or (``wire_fed``) from its v3 bytes fed a stage at a time to a
    client on ``mesh``, through ``WireStoreReceiver``."""
    prog = world["progs"][name]
    receiver = feed = None
    if wire_fed:
        blob, ends = world["blobs"][name], _stage_ends(world["blobs"][name])
        client = ProgressiveClient(mesh=mesh, device="cpu")
        receiver = WireStoreReceiver(client, prog)

        def feed():
            s = client.stages_complete
            client.feed(blob[ends[s] if s else 0:ends[s + 1]])
        feed()
    srv = ProgressiveServer(world["models"][name], prog, max_len=8 + STEPS, resident=resident,
                            receiver=receiver, mesh=mesh, device="cpu")
    srv.receive_stage()
    srv.start(world["batches"][name])
    res = srv.decode(STEPS, stage_arrival=lambda i: i % 2 == 1 and (feed is None or
                                                                    feed() is None))
    return srv, res


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_server_equals_single_device(world, name):
    """The single stream at n = 2 in both residencies, stages landing
    mid-decode, pulled and wire-fed (``WireStoreReceiver`` over a sharded
    client): tokens and stages equal to one device's, the last logits
    within B2's CPU tolerance, the same resident bytes; the store gathers
    the tied embedding and the recurrences' ``conv_w`` and ``r`` whole on
    the home device, and ``resident_report()`` counts them in
    ``gathered_bytes``."""
    for resident in ("quantized", "fp"):
        one, r1 = _server(world, name, None, resident)
        _, rw = _server(world, name, _mesh(2), resident, wire_fed=True)
        assert torch.equal(rw.tokens, r1.tokens) and rw.stage_at_step == r1.stage_at_step
        two, r2 = _server(world, name, _mesh(2), resident)
        assert torch.equal(r2.tokens, r1.tokens) and r2.stage_at_step == r1.stage_at_step
        assert len(set(r1.stage_at_step)) > 1, resident
        torch.testing.assert_close(two.last_logits, one.last_logits, rtol=RTOL, atol=ATOL)
        rep1, rep2 = one.resident_report(), two.resident_report()
        assert rep2["quantized_bytes"] == rep1["quantized_bytes"]
        assert rep2["fp_bytes"] == rep1["fp_bytes"]
        store = two.state.store
        gathered = {k for k, g in store._gathered.items() if g}
        want = {("embed",)} | {k for k in store._groups
                               if _path(k).endswith(("mamba2/mixer/conv_w", "slstm/mixer/r"))}
        assert gathered == want
        assert len(want) == {XLSTM: 2, ZAMBA: 7, SEAMLESS: 1, VISION: 1}[name]
        leaves = dict(tree_flatten_with_path(two.params))
        nbytes = 0
        for k in want:
            leaf = leaves[k]
            assert not isinstance(leaf, ShardedLeaf), k
            t = getattr(leaf, "q", leaf)
            nbytes += t.numel() * t.element_size()
        # every other split leaf comes back sharded and reaches only dense
        assert any(isinstance(v, ShardedLeaf) for v in leaves.values())
        assert rep2["gathered_bytes"] == store.gathered_bytes() == nbytes, resident


def _pool_requests(name, cfg):
    rng = np.random.default_rng(4)
    out = []
    for rid, length in enumerate([12, 20, 9, 16]):
        req = PoolRequest(rid=rid, prompt=rng.integers(0, 256, length),
                          max_new_tokens=int(rng.integers(8, 12)))
        if name == VISION:
            req.extras["vision_embeds"] = rng.standard_normal(
                (cfg.vision_tokens, cfg.d_vision)).astype(np.float32)
        out.append(req)
    return out


@pytest.mark.parametrize("name", [XLSTM, ZAMBA, VISION])
def test_sharded_pool_equals_single_device(world, name):
    """The slot pool at n = 2 on four requests in three slots, an upgrade a
    window from stage 1: the recurrent archs with chunked admission and
    the per-slot zeroing of a reused slot's state, the vision arch at
    batch 1 with an image a request; tokens, stage log and admission
    stages equal to one device's."""
    model, prog = world["models"][name], world["progs"][name]
    runs = []
    for mesh in (None, _mesh(2)):
        pool = SlotPoolEngine(model, prog, n_slots=3, max_len=48, resident="quantized",
                              dispatch_window=4, prefill_chunk=8, mesh=mesh, device="cpu")
        assert pool.chunked_prefill == (name != VISION)
        pool.receive_stage()
        for req in _pool_requests(name, model.cfg):
            pool.submit(req)
        out = pool.run(on_window=lambda _: pool.upgrade_if_available())
        runs.append((out, pool.stage_log, pool.admit_stage, pool.stage))
    assert runs[1] == runs[0] and len(runs[0][0]) == 4 and runs[0][3] > 1


@pytest.mark.parametrize("name", [SEAMLESS, VISION])
def test_sharded_speculation_equals_single_device(world, name):
    """``SpeculativeEngine`` at stage 8 on n = 2: the tokens of one
    device's, and of the plain sharded server; no extra draft bytes."""
    model, prog = world["models"][name], world["progs"][name]
    got = []
    for mesh in (None, _mesh(2)):
        spec = SpeculativeEngine(model, prog, max_len=8 + STEPS + 3,
                                 spec=SpecConfig(draft_bits=4, k=2, k_max=4), mesh=mesh, device="cpu")
        for _ in range(prog.n_stages):
            spec.receive_stage()
        spec.start(world["batches"][name])
        got.append(spec.decode(STEPS).tokens)
        assert spec.resident_report()["extra_draft_bytes"] == 0
    plain = ProgressiveServer(model, prog, max_len=8 + STEPS + 3, resident="quantized",
                              mesh=_mesh(2), device="cpu")
    for _ in range(prog.n_stages):
        plain.receive_stage()
    plain.start(world["batches"][name])
    assert torch.equal(got[1], got[0])
    assert torch.equal(got[1], plain.decode(STEPS).tokens)


@pytest.mark.parametrize("leaf", ["mamba2/mixer/conv_w", "slstm/mixer/r"])
def test_elementwise_read_of_a_sharded_leaf_raises(world, monkeypatch, leaf):
    """With the recurrences' leaves taken out of the gather rule, a split
    ``conv_w`` or ``r`` reaches its recurrence as a ``ShardedLeaf``, which
    raises ``TypeError`` naming it (never gathered quietly); so do a torch
    function, an operator, an index and a tensor method on any
    ``ShardedLeaf``."""
    name = ZAMBA if leaf.startswith("mamba2") else XLSTM
    monkeypatch.setattr(sharding, "GATHERED_LEAVES", sharding.GATHERED_LEAVES[:1])
    srv = ProgressiveServer(world["models"][name], world["progs"][name], max_len=8 + STEPS,
                            resident="quantized", mesh=_mesh(2), device="cpu")
    srv.receive_stage()
    with pytest.raises(TypeError, match=f"sharded leaf 'decoder/cycles/0_{leaf}'"):
        srv.start(world["batches"][name])
    split = srv.state.store.quantized_leaves()[("decoder", "cycles", f"0_{leaf.split('/')[0]}",
                                                *leaf.split("/")[1:])]
    assert isinstance(split, ShardedLeaf) and split.axis == -1
    for read in (lambda w: torch.einsum("i,...i->...", torch.ones(w.shape[-1]), w),
                 lambda w: torch.ones(w.shape) * w, lambda w: w * 2, lambda w: w[0],
                 lambda w: w.to(torch.float32), lambda w: w.float()):
        with pytest.raises(TypeError, match=f"0_{leaf}"):
            read(split)
    assert not hasattr(split, "no_such_attribute")


def test_narrow_split_joins_for_one_launch(world):
    """xlstm-125m's mLSTM gate projection ``w_if`` (N = 2 H = 8) splits into
    shards of 4 and 2 columns at n = 2 and 4: still one B7 call, and its
    product equals the whole weight's on the CPU (B7 joins such shards for
    one B2 launch on the card)."""
    store = ShardedPlaneStore.from_model(world["progs"][XLSTM], _mesh(4))
    for i in range(world["progs"][XLSTM].n_stages):
        store.ingest(world["progs"][XLSTM].stage(i + 1))
    w = store.quantized_leaves()[("decoder", "cycles", "1_mlstm", "mixer", "w_if")]
    assert isinstance(w, ShardedLeaf) and w.sizes() == [2, 2, 2, 2]
    from repro_torch.models.common import dense
    from repro_torch.models.transformer import layer

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 128)).astype(np.float32))
    ops.reset_launch_counts()
    y = dense(x, layer(w, 0), dtype=torch.float32)
    whole = layer(w.gather(), 0)
    torch.testing.assert_close(y, dense(x, whole, dtype=torch.float32), rtol=RTOL, atol=ATOL)
    assert ops.LAUNCH_COUNTS["sharded_dequant_matmul"] == 1


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("name", ARCHS)
def test_store_matches_reference(world, name, n):
    """Routes, placement, fingerprints after every stage, accumulators and
    every leaf gathered, exactly; one ``plane_or_segments`` launch a
    sub-store a stage."""
    blob, out = world["blobs"][name], _reference(world, name)
    ends = set(_stage_ends(blob)[1:])
    client = ProgressiveClient(mesh=_mesh(n), device="cpu")
    ops.reset_launch_counts()
    prev, fps = 0, {}
    for c in world["cuts"][name]:
        client.feed(blob[prev:c])
        prev = c
        if c in ends:
            fps[str(client.stages_complete)] = client.store.fingerprint()
    st = client.store
    assert isinstance(st, ShardedPlaneStore) and len(fps) == 8
    assert fps == _json(out[f"{n}/fps"])
    routes = {k: list(v) for k, v in st._route.items()}
    assert routes == _json(out[f"{n}/route"])
    # no reduced width divides by 3: every key whole at n = 3
    assert {kind for kind, _ in routes.values()} == ({"whole"} if n == 3 else {"split", "whole"})
    assert [[list(p) for p in st.placement(i)] for i in range(st.n_tensors)] == \
        _json(out[f"{n}/placement"])
    assert ops.LAUNCH_COUNTS["plane_or_segments"] == 8 * n
    for i in range(st.n_tensors):
        np.testing.assert_array_equal(st.acc(i).numpy(), out[f"{n}/acc/{i}"])
    for k, v in st.materialize_leaves().items():
        np.testing.assert_array_equal(_gathered(v).numpy(), out[f"{n}/fp/{k}"], err_msg=k)
    for k, v in st.quantized_leaves().items():
        v = _gathered(v)
        for f in ("q", "scale", "offset", "received_bits"):
            np.testing.assert_array_equal(getattr(v, f, v).numpy(), out[f"{n}/q/{k}/{f}"],
                                          err_msg=f"{k} {f}")


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_session_matches_reference_single_device(world, name):
    """The quantized byte-clock session on 2 shards, with the arch's memory
    input: tokens and per-step stages equal the reference's single-device
    run, every projection through B7."""
    out = _reference(world, name)
    ops.reset_launch_counts()
    r = Session.from_scenario(world["blobs"][name], get_scenario("browser-lte-handoff"),
                              seed=1, device="cpu").run_serving(
        world["models"][name], world["progs"][name], decode_steps=STEPS,
        batch=world["batches"][name], resident="quantized", mesh=_mesh(2))
    np.testing.assert_array_equal(r.tokens.numpy(), out["serve/tokens"])
    assert r.stage_at_step == out["serve/stages"].tolist()
    assert len(set(r.stage_at_step)) > 1
    assert ops.LAUNCH_COUNTS["sharded_dequant_matmul"] > 0
